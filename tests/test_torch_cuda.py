"""The port's CUDA kernels against their plain PyTorch versions, and the
serving path on the card against the CPU.  Needs a CUDA card (``gpu``
marker; each test skips without one) and imports nothing of JAX, so it
runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import warnings

import pytest
import torch

from repro_torch.kernels import kld_accept as kl
from repro_torch.kernels import ngram_match as ng
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_attention_quant as pq
from repro_torch.kernels import ragged_attention as ra
from repro_torch.models.cache import quantize_kv

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged(b, t, h, kv, d, n, bs, maxb, dtype, device, seed=0):
    """Ragged scattered tables with a -1 hole, a row with no block at
    all, and empty (-1) pool slots."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, h, d, generator=g)
    pk = torch.randn(n, bs, kv, d, generator=g)
    pv = torch.randn(n, bs, kv, d, generator=g)
    table = torch.full((b, maxb), -1, dtype=torch.int32)
    kv_pos = torch.full((n, bs), -1, dtype=torch.int32)
    q_pos = torch.zeros((b, t), dtype=torch.int32)
    perm = torch.randperm(n, generator=g).tolist()
    for i in range(1, b):
        ntok = t + (37 * i * bs) % (maxb * bs - t + 1)
        for lb in range(-(-ntok // bs)):
            if lb == 1 and ntok > 2 * bs:
                continue
            table[i, lb] = perm.pop()
            for s in range(bs):
                if lb * bs + s < ntok:
                    kv_pos[table[i, lb], s] = lb * bs + s
        q_pos[i] = torch.arange(ntok - t, ntok)
    q_pos[0] = torch.arange(t) + 3
    out = [q.to(dtype), pk.to(dtype), pv.to(dtype), table, q_pos, kv_pos]
    return [x.to(device).contiguous() for x in out]


@pytest.mark.parametrize("window", [None, 12])
# bf16: both sides accumulate in fp32 and round once, so they may differ
# by one bf16 ulp of the output (rtol) or a few ulps near 0 (atol)
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 1e-4),
                                             (torch.bfloat16, 2e-3, 1e-2)])
# (4, 11, 3, 1, ...): a rank's heads of smollm-135m on a 1 x 3 mesh
@pytest.mark.parametrize("shape", [(4, 1, 9, 3, 64, 40, 16, 8),
                                   (4, 11, 9, 3, 64, 40, 16, 8),
                                   (3, 6, 8, 8, 32, 30, 8, 9),
                                   (2, 3, 4, 1, 128, 20, 32, 6),
                                   (4, 11, 3, 1, 64, 40, 16, 8)])
def test_paged_attention_kernel_matches_plain(cuda, shape, dtype, atol, rtol,
                                              window):
    args = _paged(*shape, dtype=dtype, device=cuda)
    got = pa.paged_ragged_verify_attention_cuda(*args, window=window)
    want = pa.paged_ragged_verify_attention_plain(*args, window=window)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())          # the row with no valid slot


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 1e-4),
                                             (torch.bfloat16, 2e-3, 1e-2)])
@pytest.mark.parametrize("shape", [(4, 1, 9, 3, 64, 40, 16, 8),
                                   (4, 11, 9, 3, 64, 40, 16, 8),
                                   (3, 6, 8, 8, 32, 30, 8, 9),
                                   (4, 1, 3, 1, 64, 40, 16, 8),
                                   (4, 11, 3, 1, 64, 40, 16, 8)])
def test_quant_attention_kernel_matches_plain(cuda, shape, dtype, atol, rtol,
                                              window):
    """B4 on the int8 pool: the same ragged tables (a -1 hole, a row with
    no block at all, empty slots); q and the output in ``dtype``."""
    q, pk, pv, table, q_pos, kv_pos = _paged(*shape, dtype=torch.float32,
                                             device=cuda)
    (pk, ks), (pv, vs) = quantize_kv(pk * 3), quantize_kv(pv)
    args = [q.to(dtype), pk, pv, ks, vs, table, q_pos, kv_pos]
    got = pq.paged_ragged_verify_attention_quant_cuda(*args, window=window)
    want = pq.paged_ragged_verify_attention_quant_plain(*args, window=window)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())          # the row with no valid slot


PAGED_SHAPES = [(4, 1, 9, 3, 64, 40, 16, 8), (4, 11, 9, 3, 64, 40, 16, 8),
                (3, 6, 8, 8, 32, 30, 8, 9), (2, 3, 4, 1, 128, 20, 32, 6)]
TOLS = [(torch.float32, 2e-5, 1e-4), (torch.bfloat16, 2e-3, 1e-2)]


def _quant(args, dtype):
    """B4's inputs from :func:`_paged`'s fp32 ones: int8 pools (K x 3, a
    wider range of scales), q in ``dtype``."""
    q, pk, pv, table, q_pos, kv_pos = args
    (pk, ks), (pv, vs) = quantize_kv(pk * 3), quantize_kv(pv)
    return [q.to(dtype), pk, pv, ks, vs, table, q_pos, kv_pos]


def _full(b, t, ctx, dtype, device, seed=0):
    """Every row holds ``ctx`` positions in scattered blocks of 16 and
    queries at its last ``t`` (smollm's heads: 9 / 3, D 64)."""
    h, kv, d, bs = 9, 3, 64, 16
    g = torch.Generator().manual_seed(seed)
    maxb = ctx // bs
    n = b * maxb + 8
    q = torch.randn(b, t, h, d, generator=g)
    pk = torch.randn(n, bs, kv, d, generator=g)
    pv = torch.randn(n, bs, kv, d, generator=g)
    table = torch.randperm(n, generator=g)[:b * maxb].reshape(b, maxb).int()
    kv_pos = torch.full((n, bs), -1, dtype=torch.int32)
    kv_pos[table.reshape(-1).long()] = torch.arange(
        ctx, dtype=torch.int32).reshape(maxb, bs).repeat(b, 1)
    q_pos = (ctx - t + torch.arange(t, dtype=torch.int32))[None].repeat(b, 1)
    out = [q.to(dtype), pk.to(dtype), pv.to(dtype), table, q_pos, kv_pos]
    return [x.to(device).contiguous() for x in out]


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("splits", [1, 2, 7, "maxb+3"])
def test_paged_attention_kernel_forced_splits(cuda, splits, shape, dtype,
                                              atol, rtol, window):
    """B1 with S forced: one split, a few, and more splits than table
    entries (some empty), against the plain version."""
    args = _paged(*shape, dtype=dtype, device=cuda)
    s = shape[-1] + 3 if splits == "maxb+3" else splits
    got = pa.paged_ragged_verify_attention_cuda(*args, window=window, splits=s)
    want = pa.paged_ragged_verify_attention_plain(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())          # the row with no valid slot


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("shape", PAGED_SHAPES[:3])
@pytest.mark.parametrize("splits", [1, 2, 7, "maxb+3"])
def test_quant_attention_kernel_forced_splits(cuda, splits, shape, dtype,
                                              atol, rtol, window):
    args = _quant(_paged(*shape, dtype=torch.float32, device=cuda), dtype)
    s = shape[-1] + 3 if splits == "maxb+3" else splits
    got = pq.paged_ragged_verify_attention_quant_cuda(*args, window=window,
                                                      splits=s)
    want = pq.paged_ragged_verify_attention_quant_plain(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("kernel", ["fp", "int8"])
def test_paged_kernels_full_context_2048(cuda, kernel, dtype, atol, rtol):
    """B1 and B4 at ctx 2048, T 11 (the split plan's many-split case),
    and bit-identical output on a second launch: the splits merge in a
    fixed order, with no atomics."""
    args = _full(4, 11, 2048, dtype if kernel == "fp" else torch.float32,
                 cuda, seed=11)
    if kernel == "fp":
        run = lambda **kw: pa.paged_ragged_verify_attention_cuda(*args, **kw)
        want = pa.paged_ragged_verify_attention_plain(*args)
    else:
        args = _quant(args, dtype)
        run = lambda **kw: pq.paged_ragged_verify_attention_quant_cuda(*args,
                                                                       **kw)
        want = pq.paged_ragged_verify_attention_quant_plain(*args)
    got = run()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert torch.equal(got, run())
    for s in (1, 7):
        again = run(splits=s)
        torch.testing.assert_close(again.float(), want.float(), atol=atol,
                                   rtol=rtol)
        assert torch.equal(again, run(splits=s))


@pytest.mark.parametrize("kernel", ["fp", "int8"])
def test_paged_kernels_bit_identical_launches(cuda, kernel):
    """Two launches on the same ragged inputs give the same bits, for the
    planned split and for S past the table's width."""
    args = _paged(*PAGED_SHAPES[1], dtype=torch.float32, device=cuda)
    fn = pa.paged_ragged_verify_attention_cuda
    if kernel == "int8":
        args = _quant(args, torch.float32)
        fn = pq.paged_ragged_verify_attention_quant_cuda
    for s in (None, 3, 11):
        assert torch.equal(fn(*args, window=12, splits=s),
                           fn(*args, window=12, splits=s))


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("kernel", ["fp", "int8"])
@pytest.mark.parametrize("shape", [(4, 22, 9, 3, 64, 40, 16, 8),
                                   (3, 11, 32, 4, 128, 30, 16, 8)],
                         ids=["GT66", "D128-GT88"])
@pytest.mark.parametrize("splits", [None, 1])
def test_paged_kernels_past_one_launch_of_query_rows(cuda, splits, shape,
                                                     kernel, dtype, atol,
                                                     rtol):
    """B1 and B4 where G * T passes one launch's rows (64, 32 at D 128:
    smollm at SL 21, a D-128 target with G 8 at SL 10): the wrapper cuts
    T into launches, counts one, and matches the plain version; two calls
    give the same bits."""
    args = _paged(*shape, dtype=dtype if kernel == "fp" else torch.float32,
                  device=cuda)
    fn, plain, key = (pa.paged_ragged_verify_attention_cuda,
                      pa.paged_ragged_verify_attention_plain, pa.LAUNCHES)
    if kernel == "int8":
        args = _quant(args, dtype)
        fn, plain, key = (pq.paged_ragged_verify_attention_quant_cuda,
                          pq.paged_ragged_verify_attention_quant_plain,
                          pq.LAUNCHES)
    name = next(iter(key))
    key[name] = 0
    got = fn(*args, splits=splits)
    assert key[name] == 1
    want = plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())          # the row with no valid slot
    assert torch.equal(got, fn(*args, splits=splits))


def _ring(b, t, h, kv, d, w, dtype, device, seed=0, wrap=False):
    """Dense-ring inputs: row b holds positions [0, len + t) at p % W
    (with ``wrap`` it has run past W, up to 3W); row 0 holds nothing, so
    its queries have no valid slot."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, h, d, generator=g)
    kb = torch.randn(b, w, kv, d, generator=g)
    vb = torch.randn(b, w, kv, d, generator=g)
    hi = 3 * w if wrap else max(w - t, t + 1)
    lens = torch.randint(w if wrap else t, hi, (b,), generator=g)
    q_pos = (lens[:, None] + torch.arange(t)[None]).int()
    j = torch.arange(w)[None]
    latest = j + w * torch.div(lens[:, None] + t - 1 - j, w,
                               rounding_mode="floor")
    kv_pos = torch.where(latest >= 0, latest, -1).int()
    kv_pos[0] = -1
    out = [q.to(dtype), kb.to(dtype), vb.to(dtype), q_pos, kv_pos]
    return [x.to(device).contiguous() for x in out]


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 1e-4),
                                             (torch.bfloat16, 2e-3, 1e-2)])
# the serving shapes (smollm: 9/3 heads, D 64, W 256), then the
# reference's kernel sweep, whose W = 96 and 160 leave a ragged last tile
@pytest.mark.parametrize("shape", [(4, 1, 9, 3, 64, 256),
                                   (4, 11, 9, 3, 64, 256),
                                   (2, 1, 8, 2, 64, 128),
                                   (3, 6, 8, 8, 64, 256),
                                   (2, 11, 12, 4, 128, 96),
                                   (1, 4, 4, 1, 32, 512),
                                   (2, 3, 16, 16, 64, 160)])
def test_ragged_attention_kernel_matches_plain(cuda, shape, dtype, atol, rtol,
                                               window):
    args = _ring(*shape, dtype=dtype, device=cuda)
    got = ra.ragged_verify_attention_cuda(*args, window=window)
    want = ra.ragged_verify_attention_plain(*args, window=window)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())          # the row with no valid slot


@pytest.mark.parametrize("w", [80, 96, 160, 272])
def test_ragged_attention_kernel_on_a_wrapped_ring(cuda, w):
    """Window 64 over rings of window + 16 (and wider) slots whose rows
    have run past W: slots hold the latest positions, some outside the
    window."""
    args = _ring(4, 11, 9, 3, 64, w, torch.float32, cuda, seed=w, wrap=True)
    got = ra.ragged_verify_attention_cuda(*args, window=64)
    want = ra.ragged_verify_attention_plain(*args, window=64)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


RING_SHAPES = [(4, 1, 9, 3, 64, 256), (4, 11, 9, 3, 64, 256),
               (3, 6, 8, 8, 64, 80), (2, 11, 12, 4, 128, 96),
               (2, 3, 16, 16, 64, 272)]


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("shape", RING_SHAPES)
@pytest.mark.parametrize("splits", [1, 2, 7, "stages+3"])
def test_ragged_attention_kernel_forced_splits(cuda, splits, shape, dtype,
                                               atol, rtol, window):
    """B5 with S forced over the ring's 16-slot chunks: one split, a few,
    and three more than the ring's 64-slot stages, against the plain
    version and its split-and-merge version."""
    args = _ring(*shape, dtype=dtype, device=cuda)
    w = shape[-1]
    s = -(-w // 64) + 3 if splits == "stages+3" else splits
    got = ra.ragged_verify_attention_cuda(*args, window=window, splits=s)
    want = ra.ragged_verify_attention_plain(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    split = ra.ragged_verify_attention_split_plain(
        *[x.cpu() for x in args], window=window, splits=s)
    torch.testing.assert_close(got.float().cpu(), split.float(), atol=atol,
                               rtol=rtol)
    assert bool((got[0] == 0).all())          # the row with no valid slot


def _partial(t, w, fills, dtype, device, seed=0):
    """Ring rows holding positions 0 .. n-1 in slots 0 .. n-1 (n from
    ``fills``, one a row), the rest empty, queries at positions
    max(n - t, 0) ...; smollm's heads.  K/V in the slots 15 or more past
    a row's last position are NaN: those lie only in chunks without a
    live slot, which the kernel must neither copy nor multiply."""
    h, kv, d = 9, 3, 64
    b = len(fills)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, h, d, generator=g)
    kb = torch.randn(b, w, kv, d, generator=g)
    vb = torch.randn(b, w, kv, d, generator=g)
    n = torch.tensor(fills)
    j = torch.arange(w)[None]
    kv_pos = torch.where(j < n[:, None], j, -1).int()
    q_pos = ((n - t).clamp(min=0)[:, None] + torch.arange(t)[None]).int()
    dead = j >= n[:, None] + 15
    out = [q.to(dtype), kb.to(dtype), vb.to(dtype), q_pos, kv_pos]
    return [x.to(device).contiguous() for x in out], dead.to(device)


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("t", [1, 11])
@pytest.mark.parametrize("splits", [None, 1, 3, 35])
def test_ragged_attention_kernel_on_partial_rings(cuda, splits, t, dtype,
                                                  atol, rtol):
    """Rows of 0, 1, 40 and 300 positions in one call at W 512: against
    the plain version, the row of 0 exactly 0, two launches the same
    bits, and the same bits again with NaN K/V in the dead chunks (the
    kv_pos-first skip reads none of their bytes)."""
    args, dead = _partial(t, 512, [0, 1, 40, 300], dtype, cuda, seed=t)
    got = ra.ragged_verify_attention_cuda(*args, splits=splits)
    want = ra.ragged_verify_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())
    assert torch.equal(got, ra.ragged_verify_attention_cuda(*args,
                                                            splits=splits))
    poisoned = list(args)
    for i in (1, 2):
        poisoned[i] = args[i].masked_fill(dead[:, :, None, None], float("nan"))
    assert torch.equal(got, ra.ragged_verify_attention_cuda(*poisoned,
                                                            splits=splits))


def test_ragged_attention_kernel_wrapped_window_bits(cuda):
    """The wrapped windowed ring (window 64, W 80): two launches give the
    same bits at the planned S and at S past the ring's chunks."""
    args = _ring(4, 11, 9, 3, 64, 80, torch.float32, cuda, seed=5, wrap=True)
    want = ra.ragged_verify_attention_plain(*args, window=64)
    for s in (None, 2, 8):
        got = ra.ragged_verify_attention_cuda(*args, window=64, splits=s)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
        assert torch.equal(got, ra.ragged_verify_attention_cuda(
            *args, window=64, splits=s))


def test_ragged_dispatch_counts_one_launch_per_call(cuda):
    ra.LAUNCHES["ragged_verify_attention"] = 0
    args = _ring(2, 1, 9, 3, 64, 96, torch.float32, cuda)
    ra.ragged_attention(*args)
    ra.ragged_attention(*args, window=64)
    assert ra.LAUNCHES["ragged_verify_attention"] == 2
    with pytest.raises(TypeError):      # int64 positions: raise, no fallback
        ra.ragged_attention(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError):     # a strided ring is refused
        ra.ragged_attention(args[0], args[1][:, ::2], args[2][:, ::2],
                            args[3], args[4][:, ::2])
    assert ra.LAUNCHES["ragged_verify_attention"] == 2


NGRAM_CASES = {
    # buf, ctx, n, k: too short a context, no match, a continuation
    # clipped at ctx, the most recent of several matches
    "short_ctx": ([1, 2, 3, 4, 5, 6, 0, 0], 3, 3, 2),
    "no_match": ([1, 2, 3, 4, 5, 6, 0, 0], 6, 3, 2),
    "clipped": ([1, 2, 1, 2, 1, 2, 0, 0], 6, 2, 4),
    "basic": ([1, 2, 3, 9, 1, 2, 3, 7, 5, 1, 2, 3, 0, 0], 12, 3, 4),
}


@pytest.mark.parametrize("case", sorted(NGRAM_CASES))
def test_ngram_kernel_edge_cases_equal_plain(cuda, case):
    buf, ctx, n, k = NGRAM_CASES[case]
    tok = torch.tensor([buf], dtype=torch.int32, device=cuda)
    c = torch.tensor([ctx], dtype=torch.int32, device=cuda)
    got = ng.ngram_suffix_propose_cuda(tok, c, n=n, k=k)
    want = ng.ngram_propose_plain(tok, c, n=n, k=k)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("l,n,k", [(256, 3, 10), (4096, 3, 10), (300, 1, 4),
                                   (97, 5, 7)])
def test_ngram_kernel_equals_plain(cuda, l, n, k):
    g = torch.Generator().manual_seed(l + n)
    b = 6
    buf = torch.randint(0, 3, (b, l), generator=g, dtype=torch.int32)
    ctx = torch.randint(0, l + 1, (b,), generator=g, dtype=torch.int32)
    ctx[:3] = torch.tensor([n, n + 1, l])
    buf[2, 10:10 + n] = buf[2, l - n:]        # the full row's suffix recurs
    buf, ctx = buf.to(cuda), ctx.to(cuda)
    got = ng.ngram_suffix_propose_cuda(buf, ctx, n=n, k=k)
    want = ng.ngram_propose_plain(buf, ctx, n=n, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].max()) > 0


def _ngram_rows(l, n, seed, b=6):
    """History-like rows from a 3-symbol alphabet (plenty of matches)
    whose ctx are 0, n, n + 1, L - 1, L and L + 3."""
    g = torch.Generator().manual_seed(seed)
    buf = torch.randint(0, 3, (b, l), generator=g, dtype=torch.int32)
    ctx = torch.tensor([0, n, n + 1, l - 1, l, l + 3], dtype=torch.int32)
    return buf, ctx


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("l", [1, 15, 16, 17, 256, 4096, 65536, 70000])
def test_ngram_kernel_sizes_equal_plain(cuda, l, n, k):
    """B3 bit for bit over row lengths on both sides of its 16-byte and
    chunk boundaries: one CTA (L <= 512), a cluster of 8 (4096), 8 chunks
    of 8192 (65536, the staged capacity) and past it (70000: each CTA walks
    two chunks)."""
    buf, ctx = _ngram_rows(l, n, seed=l + 7 * n + k)
    if l > 2 * n + 2:
        # row 3 (ctx L - 1): distinct tokens but for its suffix planted at
        # start 1, the row's only match, in the lowest chunk
        buf[3] = torch.arange(3, l + 3, dtype=torch.int32)
        buf[3, 1:1 + n] = buf[3, l - 1 - n:l - 1]
    buf, ctx = buf.to(cuda), ctx.to(cuda)
    got = ng.ngram_suffix_propose_cuda(buf, ctx, n=n, k=k)
    want = ng.ngram_propose_plain(buf, ctx, n=n, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if l > 2 * n + 2:
        assert int(want[1][3]) == min(k, l - 2 - n)


@pytest.mark.parametrize("l", [256, 4096])
def test_ngram_kernel_unaligned_rows(cuda, l):
    """Rows at a 4-byte offset from 16 bytes (and L 255, rows that
    alternate) take the vector-load path: the same bits."""
    for off, width in ((1, l), (0, l - 1), (3, l + 1)):
        buf, ctx = _ngram_rows(width, 3, seed=width + off)
        flat = torch.zeros(off + buf.numel(), dtype=torch.int32, device=cuda)
        rows = flat[off:].view(buf.shape)
        rows.copy_(buf.to(cuda))
        ctx = ctx.to(cuda)
        assert rows.is_contiguous() and rows.data_ptr() % 16 == 4 * off
        got = ng.ngram_suffix_propose_cuda(rows, ctx, n=3, k=10)
        want = ng.ngram_propose_plain(rows, ctx, n=3, k=10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(want[1].max()) > 0


@pytest.mark.parametrize("l", [40, 256, 4096, 70000])
def test_ngram_history_kernel_equals_plain(cuda, l):
    """The drafter's entry: pending read at ``length``, stale random text
    past it never read as context, length L dropping the write, and the
    buffer left as it was."""
    g = torch.Generator().manual_seed(l)
    buf = torch.randint(0, 3, (6, l), generator=g, dtype=torch.int32)
    length = torch.tensor([0, 3, l // 2, l - 2, l - 1, l], dtype=torch.int32)
    pending = torch.randint(0, 3, (6,), generator=g, dtype=torch.int32)
    buf, length, pending = buf.to(cuda), length.to(cuda), pending.to(cuda)
    ng.LAUNCHES["ngram_suffix_propose"] = 0
    for n, k in ((1, 4), (3, 10), (5, 16)):
        # row 3 (length L - 2): its suffix, pending last, planted at start 1
        buf[3, 1:n] = buf[3, l - 1 - n:l - 2]
        buf[3, n] = pending[3]
        before = buf.clone()
        got = ng.ngram_propose_history(buf, length, pending, n=n, k=k)
        want = ng.ngram_propose_history_plain(buf, length, pending, n=n, k=k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(want[1][3]) > 0
        assert torch.equal(buf, before)
    assert ng.LAUNCHES["ngram_suffix_propose"] == 3
    with pytest.raises(ValueError):     # n past the registers: raise
        ng.ngram_propose_history(buf, length, pending, n=17, k=2)
    with pytest.raises(TypeError):      # int64 pending: raise, no fallback
        ng.ngram_propose_history(buf, length, pending.long(), n=3, k=2)


def test_ngram_kernel_k_zero_launches_nothing(cuda):
    ng.LAUNCHES["ngram_suffix_propose"] = 0
    buf = torch.ones((3, 10), dtype=torch.int32, device=cuda)
    ctx = torch.tensor([10, 4, 0], dtype=torch.int32, device=cuda)
    toks, cnt = ng.ngram_propose(buf, ctx, n=2, k=0)
    assert tuple(toks.shape) == (3, 0) and not bool(cnt.any())
    assert ng.LAUNCHES["ngram_suffix_propose"] == 0


@pytest.mark.parametrize("b,t,v", [(4, 10, 49280), (2, 3, 1030), (1, 1, 77)])
def test_kld_kernel_matches_plain(cuda, b, t, v):
    g = torch.Generator().manual_seed(v)
    tl = (torch.randn(b, t + 1, v, generator=g) * 3).to(cuda)
    dl = (torch.randn(b, t, v, generator=g) * 3).to(cuda)
    tok = torch.randint(0, v, (b, t), generator=g, dtype=torch.int32).to(cuda)
    got = kl.fused_kld_accept_cuda(tl[:, :t], dl, tok)      # strided rows
    want = kl.kld_accept_plain(tl[:, :t], dl, tok)
    # KL and H in nats: absolute; p(tok) and q(tok) are often far below
    # an absolute tolerance at this vocabulary, so they are held relative
    for x, y in zip(got[:2], want[:2]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-5)
    for x, y in zip(got[2:], want[2:]):
        torch.testing.assert_close(x, y, atol=1e-9, rtol=1e-4)


@pytest.mark.parametrize("b,t,v", [(4, 10, 49280), (2, 3, 1030), (1, 1, 77)])
@pytest.mark.parametrize("chunks", [None, 1, 3, 8])
def test_kld_kernel_chunks_and_bits(cuda, chunks, b, t, v):
    """B2 with C forced (one block a row, a few, the full cluster of 8)
    through the strided ``[:, :t]`` view, tokens inside and outside
    [0, V): against the plain version, and two launches the same bits."""
    g = torch.Generator().manual_seed(v + t)
    tl = (torch.randn(b, t + 1, v, generator=g) * 3).to(cuda)
    dl = (torch.randn(b, t, v, generator=g) * 3).to(cuda)
    tok = torch.randint(-2, v + 2, (b, t), generator=g, dtype=torch.int32)
    tok[0, 0], tok[-1, -1] = -1, v                 # outside [0, V)
    tok = tok.to(cuda)
    got = kl.fused_kld_accept_cuda(tl[:, :t], dl, tok, chunks=chunks)
    want = kl.kld_accept_plain(tl[:, :t], dl, tok)
    for x, y in zip(got[:2], want[:2]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-5)
    for x, y in zip(got[2:], want[2:]):
        torch.testing.assert_close(x, y, atol=1e-9, rtol=1e-4)
    assert float(got[2][0, 0]) == 0.0 and float(got[3][-1, -1]) == 0.0
    again = kl.fused_kld_accept_cuda(tl[:, :t], dl, tok, chunks=chunks)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_kld_kernel_unaligned_rows(cuda):
    """Rows whose target and draft starts differ modulo 16 bytes (a
    scalar-read row) and rows that start mid-vector (a head and a tail)."""
    g = torch.Generator().manual_seed(9)
    n = 3 * 4 * 1030
    base = (torch.randn(2, n + 8, generator=g) * 3).to(cuda)
    tl = base[0, 1:1 + n].view(3, 4, 1030)       # rows at 1 + 1030 k floats
    dl = base[1, 6:6 + n].view(3, 4, 1030)       # at 6 + 1030 k: unlike tl
    dl_alike = base[1, 1:1 + n].view(3, 4, 1030)  # alike: head and tail
    tok = torch.randint(0, 1030, (3, 4), generator=g, dtype=torch.int32).to(cuda)
    for x_, y_ in ((tl, dl), (tl, dl_alike), (dl, tl)):
        want = kl.kld_accept_plain(x_, y_, tok)
        for c in (None, 2, 8):
            got = kl.fused_kld_accept_cuda(x_, y_, tok, chunks=c)
            for x, y in zip(got[:2], want[:2]):
                torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-5)
            for x, y in zip(got[2:], want[2:]):
                torch.testing.assert_close(x, y, atol=1e-9, rtol=1e-4)


def test_dispatch_counts_launches_on_cuda(cuda):
    pa.LAUNCHES["paged_ragged_verify_attention"] = 0
    kl.LAUNCHES["fused_kld_accept"] = 0
    pq.LAUNCHES["paged_ragged_verify_attention_quant"] = 0
    ng.LAUNCHES["ngram_suffix_propose"] = 0
    args = _paged(2, 1, 9, 3, 64, 10, 16, 4, torch.float32, cuda)
    pa.paged_ragged_attention(*args)
    x = torch.randn(1, 2, 50, device=cuda)
    kl.kld_accept_signals(x, x, torch.zeros((1, 2), dtype=torch.int32,
                                            device=cuda))
    (pk, ks), (pv, vs) = quantize_kv(args[1]), quantize_kv(args[2])
    qargs = [args[0], pk, pv, ks, vs, *args[3:]]
    pq.paged_ragged_attention_quant(*qargs)
    ng.ngram_propose(args[3], args[3][:, 0].clone(), n=1, k=2)
    assert pa.LAUNCHES["paged_ragged_verify_attention"] == 1
    assert kl.LAUNCHES["fused_kld_accept"] == 1
    assert pq.LAUNCHES["paged_ragged_verify_attention_quant"] == 1
    assert ng.LAUNCHES["ngram_suffix_propose"] == 1
    with pytest.raises(TypeError):      # int64 tables: raise, no fallback
        pa.paged_ragged_attention(*args[:3], args[3].long(), *args[4:])
    with pytest.raises(TypeError):      # fp pools are not the int8 kernel's
        pq.paged_ragged_attention_quant(args[0], *args[1:3], ks, vs, *args[3:])
    with pytest.raises(TypeError):
        ng.ngram_propose(args[3].long(), args[3][:, 0].clone(), n=1, k=2)


@pytest.mark.parametrize("drafter,kv_quant", [("model", "none"),
                                              ("model", "int8"),
                                              ("ngram", "int8"),
                                              ("ngram", "none")])
def test_engine_streams_match_cpu(cuda, drafter, kv_quant):
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = get_config("smollm-135m").reduced()
    pt = init_params(cfg, seed=2, device="cpu")
    pd = map_params(lambda a, n: a + 0.03 * n, pt,
                    init_params(cfg, seed=3, device="cpu"))
    model = drafter == "model"
    outs = []
    for device in ("cpu", cuda):
        reqs = [Request(i, prompt=list(range(5 + i, 14 + 3 * i)),
                        max_new_tokens=20) for i in range(3)]
        ServingEngine(pt, cfg, pd if model else None, cfg if model else None,
                      SpecDecodeConfig(drafter=drafter,
                                       ngram_n=3 if model else 1),
                      ServingConfig(max_batch_size=2, max_seq_len=96,
                                    kv_block_size=16, paged_kv=True,
                                    kv_quant=kv_quant),
                      device=device).run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("window", [None, 24], ids=["full", "windowed"])
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
def test_dense_engine_streams_match_cpu(cuda, pipelined, window):
    """The dense ring (B5 on the card) at the reduced width; window 24
    makes a 40-slot ring that the requests run past."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              attention_window=window)
    pt = init_params(cfg, seed=2, device="cpu")
    pd = map_params(lambda a, n: a + 0.03 * n, pt,
                    init_params(cfg, seed=3, device="cpu"))
    outs = []
    for device in ("cpu", cuda):
        ra.LAUNCHES["ragged_verify_attention"] = 0
        reqs = [Request(i, prompt=list(range(5 + i, 14 + 3 * i)),
                        max_new_tokens=40) for i in range(3)]
        ServingEngine(pt, cfg, pd, cfg, SpecDecodeConfig(),
                      ServingConfig(max_batch_size=2, max_seq_len=96,
                                    pipelined=pipelined),
                      device=device).run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert ra.LAUNCHES["ragged_verify_attention"] > 0


def _small_pair(device="cpu"):
    from repro_torch.configs import get_config
    from repro_torch.models.weights import init_params, map_params
    cfg = get_config("smollm-135m").reduced()
    pt = init_params(cfg, seed=2, device=device)
    pd = map_params(lambda a, n: a + 0.03 * n, pt,
                    init_params(cfg, seed=3, device=device))
    return cfg, pt, pd


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "ring"])
def test_self_drafter_launches_on_a_layer_sliced_view(cuda, paged):
    """The self drafter's draft loop hands B1 (pool) or B5 (ring) one
    layer of the leading-layer view ``cache["k"][:n]``: each of the
    k + 1 steps launches once per drafted layer, and the proposal equals
    the CPU's (plain versions) on the same state."""
    from repro_torch.core.config import SpecDecodeConfig
    from repro_torch.core.drafters import build_drafter
    from repro_torch.core.policies import build_policy
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.weights import map_params
    cfg, pt, _ = _small_pair()
    spec = SpecDecodeConfig(drafter="self", self_draft_layers=1)
    drafter, policy = build_drafter(spec, cfg), build_policy(spec)
    b, k = 2, 3
    props, counts = [], []
    for device in ("cpu", cuda):
        params = map_params(lambda a: a.to(device), pt)
        if paged:
            cache = cache_lib.paged_cache_struct(cfg, b, 64, 8, 16,
                                                 device=device)
            cache["block_table"][:, :4] = torch.arange(
                8, dtype=torch.int32, device=device).reshape(b, 4)
        else:
            cache = cache_lib.cache_struct(cfg, b, 64, device=device)
        view = cache["k"][:1]
        assert view.is_contiguous() and view[0].data_ptr() == cache["k"].data_ptr()
        pa.LAUNCHES["paged_ragged_verify_attention"] = 0
        ra.LAUNCHES["ragged_verify_attention"] = 0
        pending = torch.tensor([5, 9], dtype=torch.int32, device=device)
        sl = torch.tensor([k, 2], dtype=torch.int32, device=device)
        live = torch.ones((b,), dtype=torch.bool, device=device)
        prop = drafter.propose(
            None, (), pending, k, sl, policy,
            lambda j: torch.full((b,), 0.5, device=device), live,
            params_t=params, target_cache=cache)
        props.append(prop)
        counts.append(pa.LAUNCHES["paged_ragged_verify_attention"]
                      + ra.LAUNCHES["ragged_verify_attention"])
    assert counts == [0, (k + 1) * spec.self_draft_layers]
    assert torch.equal(props[0].tokens, props[1].tokens.cpu())
    assert torch.equal(props[0].eff_sl, props[1].eff_sl.cpu())
    torch.testing.assert_close(props[1].logits.cpu(), props[0].logits,
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("paged", [True, False], ids=["pool", "ring"])
def test_self_drafter_engine_streams_match_cpu(cuda, paged, pipelined):
    """The self drafter served on the card (B1 or B5 over the layer-sliced
    view, B2 for the KLD) emits the CPU's greedy streams; on the pool
    with preemption."""
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg, pt, _ = _small_pair()
    serving = (dict(paged_kv=True, max_seq_len=64, kv_block_size=8,
                    num_kv_blocks=4) if paged else dict(max_seq_len=96))
    outs, summaries = [], []
    for device in ("cpu", cuda):
        kl.LAUNCHES["fused_kld_accept"] = 0
        reqs = [Request(i, prompt=list(range(5 + i, 20 + 3 * i)),
                        max_new_tokens=24) for i in range(3)]
        summaries.append(ServingEngine(
            pt, cfg, None, None, SpecDecodeConfig(drafter="self"),
            ServingConfig(max_batch_size=2, pipelined=pipelined, **serving),
            device=device).run(reqs))
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert kl.LAUNCHES["fused_kld_accept"] > 0
    assert summaries[0]["preemptions"] == summaries[1]["preemptions"]
    if paged and not pipelined:
        assert summaries[1]["preemptions"] >= 1


def _dispatch_syncs(eng):
    """Count the synchronising calls ``eng.dispatch`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings
    seen = []
    dispatch = eng.dispatch

    def watched():
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rec = dispatch()
            seen.extend(w for w in caught if "synchroniz" in str(w.message))
            return rec
        finally:
            torch.cuda.set_sync_debug_mode("default")
    eng.dispatch = watched
    return seen


@pytest.mark.parametrize("policy,drafter", [("adaedl", "model"),
                                            ("goodput", "model"),
                                            ("goodput", "ngram"),
                                            ("slo", "model"),
                                            ("slo", "self")])
def test_new_policies_dispatch_without_syncs(cuda, policy, drafter):
    """draft_keep, observe and predict read nothing back to the host,
    and the slo pick reads only the host context: dispatch makes no
    synchronising call (the slo serve also with deadlines, once its
    latency model is ready); the streams equal the CPU's."""
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg, pt, pd = _small_pair()
    model = drafter == "model"
    spec = SpecDecodeConfig(policy=policy, drafter=drafter,
                            ngram_n=3 if model else 1)
    outs = []
    for device in ("cpu", cuda):
        eng = ServingEngine(pt, cfg, pd if model else None,
                            cfg if model else None, spec,
                            ServingConfig(max_batch_size=2, max_seq_len=96,
                                          paged_kv=True),
                            device=device)
        syncs = _dispatch_syncs(eng) if device != "cpu" else []
        reqs = [Request(i, prompt=list(range(5 + i, 14 + 3 * i)),
                        max_new_tokens=20,
                        slo_deadline_s=(60.0 if policy == "slo" and i % 2
                                        else None)) for i in range(4)]
        eng.run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert syncs == [], [str(w.message) for w in syncs]


@pytest.mark.parametrize("remat,microbatches", [(True, 1), (False, 1),
                                                (True, 2)])
def test_train_steps_card_equal_cpu(cuda, remat, microbatches):
    """Five ``train_step`` calls at the reduced width from one seeded init
    on the card and on the CPU: per-step loss within 1e-4 relative, the
    params within 1e-4, and the first step's grad norm (both sides at the
    same params) within 2e-3.  At this init the gradient is nearly
    discontinuous in the params (layer weights of std 0.71, attention
    saturated): later grad norms part by percents on 1e-5 of parameter
    change, and even at equal params the order of the fp32 sums moves
    the first one by several 1e-4 (chip_smoke.py's train-check rows)."""
    import itertools
    from repro_torch.configs import get_config
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.models.weights import init_params, param_leaves
    from repro_torch.training.data import MarkovTaskCorpus, lm_batches
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.train import train_step
    cfg = get_config("smollm-135m").reduced()
    opt = OptimizerConfig(learning_rate=1e-5, warmup_steps=2, total_steps=10)
    stream = MarkovTaskCorpus(cfg.vocab_size, peakedness=2.0).stream(12000)
    batches = list(itertools.islice(lm_batches(stream, 16, 64), 5))
    runs = []
    for device in ("cpu", cuda):
        p = init_params(cfg, seed=0, device=device)
        st = init_adamw(p)
        metrics = []
        for toks, labs in batches:
            p, st, m = train_step(p, st, torch.from_numpy(toks).to(device),
                                  torch.from_numpy(labs).to(device), cfg=cfg,
                                  opt_cfg=opt, remat=remat,
                                  microbatches=microbatches)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((p, metrics))
    for want, got in zip(runs[0][1], runs[1][1]):
        for k in ("loss", "lr"):
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    first = runs[0][1][0]["grad_norm"], runs[1][1][0]["grad_norm"]
    assert abs(first[1] - first[0]) <= 2e-3 * first[0]
    for (_, want), (_, got) in zip(param_leaves(runs[0][0]),
                                   param_leaves(runs[1][0])):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_copy_blocks_on_cuda_bit_equal_cpu(cuda, kv_quant):
    """The copy-on-write block copy on CUDA pools (K, V, kv_pos and, on
    the int8 pool, both scale pools) gives the CPU's bits, sentinel
    pairs (the drop block onto itself) included."""
    from repro_torch.configs import get_config
    from repro_torch.models import cache as cache_lib
    cfg = get_config("smollm-135m").reduced()
    c = cache_lib.paged_cache_struct(cfg, 2, 64, 12, 16, kv_quant=kv_quant)
    g = torch.Generator().manual_seed(0)
    for name, val in c.items():
        if val.dtype == torch.int8:
            val.copy_(torch.randint(-127, 128, val.shape, generator=g))
        elif val.dtype == torch.float32:
            val.copy_(torch.rand(val.shape, generator=g))
    c["kv_pos"].copy_(torch.randint(-1, 60, c["kv_pos"].shape, generator=g))
    src = torch.tensor([3, 12, 7, 12])
    dst = torch.tensor([9, 12, 1, 12])
    gpu = {k: v.to(cuda) for k, v in c.items()}
    for cache, dev in ((c, "cpu"), (gpu, cuda)):
        s, d = src.to(dev), dst.to(dev)
        cache_lib.copy_blocks(cache["k"], cache["v"], cache["kv_pos"], s, d)
        if kv_quant == "int8":
            cache_lib.copy_scales(cache["k_scale"], cache["v_scale"], s, d)
    for k in c:
        assert torch.equal(gpu[k].cpu(), c[k]), k
    assert torch.equal(c["k"][:, 9], c["k"][:, 3])


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_warm_tail_prefill_matches_plain(cuda, kv_quant):
    """A warm tail prefill of 128 tokens after 64 shared ones (G * T 384
    query rows a KV head: several launches of B1 or B4 a layer), with a
    copy-on-write pair, on the card against the plain versions on the CPU
    (logits within 2e-4 on the fp32 pool; on the int8 pool K/V that part
    by rounding can land one quantum apart, so 5e-3 and the same argmax),
    and twice on the card for the same bits (logits and every allocatable
    block)."""
    from repro_torch.configs import get_config
    from repro_torch.core import prefill as prefill_lib
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.weights import init_params
    launches = (pa.LAUNCHES if kv_quant == "none" else pq.LAUNCHES)
    key = next(iter(launches))
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, seed=4, device="cpu")
    g = torch.Generator().manual_seed(1)
    head = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                         dtype=torch.int32)
    tail = torch.randint(0, cfg.vocab_size, (2, 128), generator=g,
                         dtype=torch.int32)
    tail_lens = torch.tensor([128, 100], dtype=torch.int32)
    # row 0 holds blocks 0-3 (the shared head) then 4-11; row 1 shares
    # blocks 0-2 and takes block 3 as a COW copy into block 12
    rows = torch.full((2, 16), -1, dtype=torch.int32)
    rows[0, :12] = torch.arange(12)
    rows[1, :3] = torch.arange(3)
    rows[1, 3:11] = torch.arange(12, 20)

    def run(device):
        c = cache_lib.paged_cache_struct(cfg, 2, 256, 24, 16, device=device,
                                         kv_quant=kv_quant)
        cold = rows[:1, :4].to(device)
        prefill_lib.prefill_paged_rows(
            _to(params, device), cfg, c["k"], c["v"], c["kv_pos"], cold,
            head[:1].to(device),
            torch.tensor([64], dtype=torch.int32, device=device),
            c.get("k_scale"), c.get("v_scale"))
        view, last = prefill_lib.prefill_paged_tail(
            _to(params, device), cfg, c["k"], c["v"], c["kv_pos"],
            rows.to(device), tail.to(device),
            torch.tensor([64, 64], dtype=torch.int32, device=device),
            tail_lens.to(device),
            torch.tensor([24, 3], device=device),
            torch.tensor([24, 12], device=device),
            k_scale=c.get("k_scale"), v_scale=c.get("v_scale"))
        return last.cpu(), {k: v.cpu() for k, v in c.items()}

    want, _ = run("cpu")
    launches[key] = 0
    got, pools = run(cuda)
    assert launches[key] >= cfg.num_layers
    again, pools2 = run(cuda)
    assert torch.equal(got, again)
    # every block but the drop block (24), which takes the dropped writes
    # of both calls in no fixed order
    for k in pools:
        blocks = pools[k] if k in ("length", "block_table") else (
            pools[k][:24] if k == "kv_pos" else pools[k][:, :24])
        again_blocks = pools2[k] if k in ("length", "block_table") else (
            pools2[k][:24] if k == "kv_pos" else pools2[k][:, :24])
        assert torch.equal(blocks, again_blocks), k
    atol = 2e-4 if kv_quant == "none" else 5e-3
    torch.testing.assert_close(got, want, atol=atol, rtol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def _to(params, device):
    from repro_torch.models.weights import map_params
    return map_params(lambda t: t.to(device), params)


# --------------------------------------------------------------------------
# B1 and B5 at recurrentgemma-2b's head dims (D 256 and 320, the wide
# heads' tensor-core kernel of csrc/paged_verify.cuh: up to 128 query rows a
# KV head in one launch)
# --------------------------------------------------------------------------

# (H, KV, D): the target's local attention (G 10) and its draft's (G 2)
WIDE_HEADS = [(10, 1, 256), (2, 1, 320)]
# the row limit, G*T 128 a KV head: (H, KV, D, T)
WIDE_LIMIT = [(16, 1, 256, 8), (2, 1, 320, 64)]


def _c_calls(monkeypatch, mod):
    """The list each call of ``mod``'s C entry point appends to: one call
    launches the split kernel and at most one merge."""
    calls, real = [], mod._lib

    def counted():
        fn = real()

        def call(*args):
            calls.append(args)
            return fn(*args)
        return call
    monkeypatch.setattr(mod, "_lib", counted)
    return calls


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("heads", WIDE_HEADS)
# T 1 (G*T 10 / 2) and T 11 (110 / 22 query rows a KV head, one launch),
# over 3 sequences with the helper's holes and a row with no block
@pytest.mark.parametrize("t", [1, 11])
@pytest.mark.parametrize("window", [None, 12])
def test_paged_attention_wide_heads_match_plain(cuda, t, heads, dtype, atol,
                                                rtol, window, monkeypatch):
    h, kv, d = heads
    args = _paged(3, t, h, kv, d, 40, 16, 8, dtype, cuda, seed=d + t)
    calls = _c_calls(monkeypatch, pa)
    got = pa.paged_ragged_verify_attention_cuda(*args, window=window)
    again = pa.paged_ragged_verify_attention_cuda(*args, window=window)
    want = pa.paged_ragged_verify_attention_plain(*args, window=window)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())          # the row with no valid slot
    assert pa.query_groups(h, kv, t, d) == [(0, t)]
    assert len(calls) == 2                    # one launch a call


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("shape", WIDE_LIMIT)
@pytest.mark.parametrize("splits", [None, 3])
def test_wide_heads_at_the_row_limit(cuda, shape, dtype, atol, rtol, splits,
                                     monkeypatch):
    """G*T 128 a KV head, four row tiles of 32, in one launch on the pool
    and on the wrapped window ring; 129 rows raise."""
    h, kv, d, t = shape
    calls = {m: _c_calls(monkeypatch, m) for m in (pa, ra)}
    args = _paged(3, t, h, kv, d, 40, 16, 8, dtype, cuda, seed=d)
    got = pa.paged_ragged_verify_attention_cuda(*args, splits=splits)
    want = pa.paged_ragged_verify_attention_plain(*args)
    assert torch.equal(got, pa.paged_ragged_verify_attention_cuda(
        *args, splits=splits))
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())
    ring = _ring(2, t, h, kv, d, 2064, dtype, cuda, seed=d, wrap=True)
    got = ra.ragged_verify_attention_cuda(*ring, window=2048, splits=splits)
    want = ra.ragged_verify_attention_plain(*ring, window=2048)
    assert torch.equal(got, ra.ragged_verify_attention_cuda(
        *ring, window=2048, splits=splits))
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())
    assert len(calls[pa]) == 2 and len(calls[ra]) == 2
    with pytest.raises(ValueError):
        pa.check_verify_shape(129, 1, 1, d, 16)


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("heads", WIDE_HEADS)
@pytest.mark.parametrize("t", [1, 11])
@pytest.mark.parametrize("splits", [None, 1, 5])
def test_ragged_attention_wide_heads_on_a_wrapped_window_ring(cuda, splits, t,
                                                              heads, dtype,
                                                              atol, rtol,
                                                              monkeypatch):
    """The hybrid's ring at full width: W 2064 (window 2048 + 16 slack),
    rows that have run past W, window 2048, row 0 empty; forced splits
    too; one launch a call."""
    h, kv, d = heads
    args = _ring(2, t, h, kv, d, 2064, dtype, cuda, seed=d + t, wrap=True)
    kw = dict(window=2048, splits=splits)
    calls = _c_calls(monkeypatch, ra)
    got = ra.ragged_verify_attention_cuda(*args, **kw)
    again = ra.ragged_verify_attention_cuda(*args, **kw)
    want = ra.ragged_verify_attention_plain(*args, window=2048)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert bool((got[0] == 0).all())          # the row with no valid slot
    assert len(calls) == 2


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("heads", WIDE_HEADS)
def test_wide_heads_forced_splits_on_the_pool(cuda, heads, dtype, atol, rtol):
    """S 1 to past the table's 8 entries (empty splits), each launched
    twice for the same bits; a window that leaves some queries' slots in
    the table's hole."""
    h, kv, d = heads
    args = _paged(3, 11, h, kv, d, 40, 16, 8, dtype, cuda, seed=7)
    for window in (None, 12):
        want = pa.paged_ragged_verify_attention_plain(*args, window=window)
        for splits in (1, 2, 7, 11):
            got = pa.paged_ragged_verify_attention_cuda(*args, window=window,
                                                        splits=splits)
            assert torch.equal(got, pa.paged_ragged_verify_attention_cuda(
                *args, window=window, splits=splits))
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=rtol)
            assert bool((got[0] == 0).all())


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("heads", WIDE_HEADS)
def test_wide_heads_forced_splits_on_a_partial_ring(cuda, heads, dtype, atol,
                                                    rtol):
    """A ring of 300 slots (a ragged last chunk and stage) whose rows hold
    fewer positions than W, the rest of the ring NaN: the positions-first
    scan must stage none of the empty slots; S 1 to past the 19 chunks."""
    h, kv, d = heads
    q, kb, vb, q_pos, kv_pos = _ring(3, 11, h, kv, d, 300, dtype, cuda,
                                     seed=11)
    kb = kb.masked_fill((kv_pos < 0)[:, :, None, None], float("nan"))
    vb = vb.masked_fill((kv_pos < 0)[:, :, None, None], float("nan"))
    args = [q, kb, vb, q_pos, kv_pos]
    want = ra.ragged_verify_attention_plain(
        q, kb.nan_to_num(0.0), vb.nan_to_num(0.0), q_pos, kv_pos)
    for splits in (None, 1, 2, 6, 22):
        got = ra.ragged_verify_attention_cuda(*args, splits=splits)
        assert torch.equal(got, ra.ragged_verify_attention_cuda(
            *args, splits=splits))
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        assert bool((got[0] == 0).all())


def test_int8_kernel_refuses_wide_heads(cuda):
    """B4 stays at D <= 128: the reference has no int8 pool for the
    hybrid family, whose heads are the wide ones."""
    q, pk, pv, table, q_pos, kv_pos = _paged(2, 1, 2, 1, 256, 12, 16, 4,
                                             torch.float32, cuda)
    (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
    with pytest.raises(ValueError):
        pq.paged_ragged_verify_attention_quant_cuda(q, pk, pv, ks, vs, table,
                                                    q_pos, kv_pos)


# --------------------------------------------------------------------------
# the recurrent families on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers,paged", [("mamba2-130m", None, False),
                                               ("recurrentgemma-2b", 5, False),
                                               ("recurrentgemma-2b", 5, True)])
def test_recurrent_commit_leaves_the_snapshot(cuda, arch, layers, paged):
    """A verify pass and the masked re-advance commit on CUDA tensors
    leave the pre-round cache's recurrent rows as they were, and the
    committed state equals the CPU's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.transformer import commit, forward
    from repro_torch.models.weights import init_params
    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = init_params(cfg, seed=0, device="cpu")
    b, s = 2, 9
    toks = torch.arange(b * (s + 4), dtype=torch.int32).reshape(b, -1) % 97

    def run(device):
        p = _to(params, device)
        if paged:
            c = cache_lib.paged_cache_struct(cfg, b, 64, 16, 8, device=device)
            c["block_table"] = torch.arange(16, dtype=torch.int32,
                                            device=device).reshape(b, 8)
        else:
            c = cache_lib.cache_struct(cfg, b, 64, device=device)
        tk = toks.to(device)
        _, c = forward(p, cfg, tk[:, :s], cache=c, mode="prefill")
        c["length"] = torch.full((b,), s, dtype=torch.int32, device=device)
        before = {k: c[k].clone() for k in cache_lib.RECURRENT_KEYS if k in c}
        _, v = forward(p, cfg, tk[:, s:], cache=c, mode="decode")
        n = torch.tensor([1, 3], dtype=torch.int32, device=device)
        out = commit(p, cfg, tk[:, s:], c, v, n)
        for k, val in before.items():
            assert torch.equal(c[k], val), k
        return {k: out[k].cpu() for k in before}

    got, want = run(cuda), run("cpu")
    # fp32 rounding of the state's own scale: the random reduced models
    # drive the SSD state to ~1e4
    for k in want:
        torch.testing.assert_close(
            got[k], want[k], rtol=0,
            atol=1e-4 + 1e-5 * float(want[k].abs().max()))


# --------------------------------------------------------------------------
# the multimodal families: B1 / B4 / B5 and B2 at their shapes, the
# blockwise attention, and reduced-width card == CPU paths
# --------------------------------------------------------------------------

# (H, KV, D): qwen2-vl-2b (G 6 at D 128: a T 11 verify is three launches of
# <= 5 positions) and its served draft (H 3 / KV 1); seamless-m4t-medium's
# decoder (MHA at D 64) and its draft
VLM_HEADS = [(12, 2, 128), (3, 1, 128)]
AUDIO_HEADS = [(16, 16, 64), (4, 4, 64)]


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("heads", VLM_HEADS)
@pytest.mark.parametrize("t", [1, 11])
def test_paged_attention_vlm_heads_match_plain(cuda, t, heads, dtype, atol,
                                               rtol):
    h, kv, d = heads
    args = _paged(3, t, h, kv, d, 40, 16, 8, dtype, cuda, seed=d + t + h)
    got = pa.paged_ragged_verify_attention_cuda(*args)
    again = pa.paged_ragged_verify_attention_cuda(*args)
    want = pa.paged_ragged_verify_attention_plain(*args)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    if h == 12 and t == 11:
        assert len(pa.query_groups(h, kv, t, d)) == 3


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("t", [1, 11])
def test_quant_attention_vlm_heads_match_plain(cuda, t, dtype, atol, rtol):
    q, pk, pv, table, q_pos, kv_pos = _paged(3, t, 12, 2, 128, 40, 16, 8,
                                             torch.float32, cuda, seed=t)
    (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
    args = (q.to(dtype), pk, pv, ks, vs, table, q_pos, kv_pos)
    got = pq.paged_ragged_verify_attention_quant_cuda(*args)
    want = pq.paged_ragged_verify_attention_quant_plain(*args)
    assert torch.equal(got, pq.paged_ragged_verify_attention_quant_cuda(*args))
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("heads", VLM_HEADS[:1] + AUDIO_HEADS)
@pytest.mark.parametrize("t", [1, 11])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_ragged_attention_multimodal_heads_match_plain(cuda, splits, t, heads,
                                                       dtype, atol, rtol):
    h, kv, d = heads
    args = _ring(3, t, h, kv, d, 256, dtype, cuda, seed=d + t + h)
    got = ra.ragged_verify_attention_cuda(*args, splits=splits)
    again = ra.ragged_verify_attention_cuda(*args, splits=splits)
    want = ra.ragged_verify_attention_plain(*args)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("v", [152064, 256256])
def test_kld_kernel_at_the_multimodal_vocabularies(cuda, v):
    g = torch.Generator().manual_seed(v)
    tl = (torch.randn(4, 10, v, generator=g) * 3).to(cuda)
    dl = (torch.randn(4, 10, v, generator=g) * 3).to(cuda)
    tok = torch.randint(0, v - 128, (4, 10), generator=g,
                        dtype=torch.int32).to(cuda)
    got = kl.fused_kld_accept_cuda(tl, dl, tok)
    want = kl.kld_accept_plain(tl, dl, tok)
    for x, y in zip(got[:2], want[:2]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
    for x, y in zip(got[2:], want[2:]):
        torch.testing.assert_close(x, y, atol=1e-9, rtol=1e-4)


@pytest.mark.parametrize("t", [2048, 2500])
def test_flash_attend_matches_attend_on_the_card(cuda, t):
    """The blockwise attention against the quadratic one at smollm's
    heads, causal, with padded keys: outputs and gradients within 1e-4."""
    from repro_torch.models.flash import flash_attend
    from repro_torch.models.layers import attend
    g = torch.Generator(device="cuda").manual_seed(t)
    q, k, v, dout = (torch.randn(2, t, n, 64, generator=g, device="cuda")
                     for n in (9, 3, 3, 9))
    valid = torch.ones((2, t), dtype=torch.bool, device="cuda")
    valid[1, t - 300:] = False
    pos = torch.arange(t, device="cuda")[None].expand(2, t)
    res = []
    for fn in (lambda a, b, c: flash_attend(a, b, c, kv_valid=valid),
               lambda a, b, c: attend(a, b, c, q_pos=pos, kv_pos=pos,
                                      kv_valid=valid)):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        res.append((out.detach(),) + torch.autograd.grad(out, leaves, dout))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _mm_serve(arch, device, paged, kv_quant="none", pipelined=False):
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = get_config(arch).reduced()
    pt = init_params(cfg, seed=2, device="cpu")
    pd = init_params(cfg.draft(), seed=3, device="cpu")
    reqs = [Request(i, prompt=list(range(5 + i, 14 + 3 * i)),
                    max_new_tokens=20) for i in range(3)]
    ServingEngine(pt, cfg, pd, cfg.draft(), SpecDecodeConfig(),
                  ServingConfig(max_batch_size=2, max_seq_len=96,
                                kv_block_size=16, paged_kv=paged,
                                kv_quant=kv_quant, pipelined=pipelined),
                  device=device).run(reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("arch,paged,kv_quant,pipelined", [
    ("qwen2-vl-2b", True, "none", False), ("qwen2-vl-2b", True, "int8", False),
    ("qwen2-vl-2b", False, "none", False), ("qwen2-vl-2b", True, "none", True),
    ("seamless-m4t-medium", False, "none", False)])
def test_multimodal_engine_streams_match_cpu(cuda, arch, paged, kv_quant,
                                             pipelined):
    assert (_mm_serve(arch, cuda, paged, kv_quant, pipelined)
            == _mm_serve(arch, "cpu", paged, kv_quant, pipelined))


def test_vlm_image_prefill_and_audio_encoder_match_cpu(cuda):
    """The reduced vlm's image prefill (embeds + M-RoPE positions into
    the pool, T 1 and T 11 decode steps) and the reduced audio model's
    encoder and cross cache: card == CPU within 1e-4, on the reduced init
    scaled by 0.2 (at its own scale attention saturates, and the card's
    and the CPU's orders of fp32 sums part by up to 2.7e-4 in the cross
    K/V, whose values reach 40)."""
    from repro_torch.configs import get_config
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.transformer import (build_cross_cache, encode,
                                                forward)
    from repro_torch.models.weights import init_params, map_params

    def conditioned(c):
        return map_params(lambda a: a * 0.2, init_params(c, seed=2,
                                                         device="cpu"))
    cfg = get_config("qwen2-vl-2b").reduced()
    pt = conditioned(cfg)
    g = torch.Generator().manual_seed(0)
    emb = torch.randn(2, 20, cfg.d_model, generator=g) * 0.3
    pos = torch.randint(0, 30, (2, 20, 3), generator=g, dtype=torch.int32)
    outs = []
    for dev in ("cpu", cuda):
        c = cache_lib.paged_cache_struct(cfg, 2, 64, 8, 16, device=dev)
        c["block_table"][:] = torch.arange(8, dtype=torch.int32,
                                           device=dev).reshape(2, 4)
        p = _to(pt, dev)
        pl, c = forward(p, cfg, None, cache=c, mode="prefill",
                        embeds=emb.to(dev), rope_positions=pos.to(dev))
        c["length"] = torch.full((2,), 20, dtype=torch.int32, device=dev)
        toks = torch.arange(11, dtype=torch.int32, device=dev)[None].repeat(2, 1)
        d1, _ = forward(p, cfg, toks[:, :1], cache=c, mode="decode")
        d11, _ = forward(p, cfg, toks, cache=c, mode="decode")
        outs.append([x.cpu() for x in (pl, d1, d11)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    cfg = get_config("seamless-m4t-medium").reduced()
    pt = conditioned(cfg)
    frames = torch.randn(2, 9, cfg.d_model, generator=g) * 0.3
    outs = []
    for dev in ("cpu", cuda):
        p = _to(pt, dev)
        ck, cv = build_cross_cache(p, cfg, encode(p, cfg, frames.to(dev)))
        outs.append((ck.cpu(), cv.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the dispatchers' shape-only branch (the dry run's stand-ins)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["ring", "paged", "quant"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shape_only_branch(cuda, kernel, dtype):
    """A fake CUDA tensor reaches no kernel: the dispatcher returns the
    kernel's output shape and dtype, records one call with the dry run's
    counter at the kernel's own formula (full extent), and launches
    nothing."""
    from repro_torch.kernels.shape_only import attention_cost
    from repro_torch.launch.op_cost import OpCounter
    b, t, h, kv, d, w, n, bs, maxb = 4, 11, 12, 4, 128, 256, 64, 16, 16
    launches = (dict(ra.LAUNCHES), dict(pa.LAUNCHES), dict(pq.LAUNCHES))
    with OpCounter() as c:
        q = torch.empty(b, t, h, d, dtype=dtype, device=cuda)
        q_pos = torch.empty(b, t, dtype=torch.int32, device=cuda)
        if kernel == "ring":
            k = torch.empty(b, w, kv, d, dtype=dtype, device=cuda)
            kv_pos = torch.empty(b, w, dtype=torch.int32, device=cuda)
            out = ra.ragged_attention(q, k, k, q_pos, kv_pos, window=None)
            name, want = "ragged_verify_attention", attention_cost(
                b, t, h, d, w, kv, q.element_size(), k.element_size(),
                4 * (b * w + b * t))
        else:
            table = torch.empty(b, maxb, dtype=torch.int32, device=cuda)
            kv_pos = torch.empty(n, bs, dtype=torch.int32, device=cuda)
            extra = 4 * (b * maxb * bs + b * maxb + b * t)
            if kernel == "paged":
                pool = torch.empty(n, bs, kv, d, dtype=dtype, device=cuda)
                out = pa.paged_ragged_attention(q, pool, pool, table, q_pos,
                                                kv_pos)
                name, want = "paged_ragged_verify_attention", attention_cost(
                    b, t, h, d, maxb * bs, kv, q.element_size(),
                    pool.element_size(), extra)
            else:
                pool = torch.empty(n, bs, kv, d, dtype=torch.int8,
                                   device=cuda)
                sc = torch.empty(n, bs, kv, dtype=torch.float32, device=cuda)
                out = pq.paged_ragged_attention_quant(q, pool, pool, sc, sc,
                                                      table, q_pos, kv_pos)
                name = "paged_ragged_verify_attention_quant"
                want = attention_cost(b, t, h, d, maxb * bs, kv,
                                      q.element_size(), 1 + 4.0 / d, extra)
        assert tuple(out.shape) == (b, t, h, d) and out.dtype == dtype
        assert out.device == q.device
    assert dict(c.kernel_calls) == {name: 1.0}
    assert (c.kernel_flops, c.kernel_bytes) == want
    assert want[0] == 4.0 * b * t * h * d * (w if kernel == "ring"
                                             else maxb * bs)
    assert (dict(ra.LAUNCHES), dict(pa.LAUNCHES),
            dict(pq.LAUNCHES)) == launches


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "pool"])
def test_nccl_one_rank_mesh_engine_matches_unmeshed(cuda, paged):
    """A real NCCL communicator of one rank (``launch.mesh.serving_mesh``
    1 x 1): a group of one rank makes the mesh path's collectives no-ops,
    so the meshed engine launches none, its streams equal the unmeshed
    engine's on the card and its dispatch makes no synchronising call;
    the communicator's own all-reduce and all-gather are enqueued on the
    stream with no synchronising call either."""
    import socket
    import torch.distributed as dist
    from repro_torch.core import tp
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg, pt, pd = _small_pair()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = serving_mesh("1x1")
        outs, syncs = [], []
        for m in (None, mesh):
            eng = ServingEngine(pt, cfg, pd, cfg, SpecDecodeConfig(),
                                ServingConfig(max_batch_size=2,
                                              max_seq_len=96,
                                              paged_kv=paged),
                                device=cuda, mesh=m)
            syncs = _dispatch_syncs(eng)
            tp.reset_counts()
            reqs = [Request(i, prompt=list(range(5 + i, 14 + 3 * i)),
                            max_new_tokens=20) for i in range(4)]
            eng.run(reqs)
            outs.append([r.output for r in reqs])
        assert not any(tp.COUNTS.values()), tp.COUNTS
        assert outs[0] == outs[1]
        assert syncs == [], [str(w.message) for w in syncs]
        group = mesh.get_group("model")
        x = torch.arange(64, dtype=torch.float32, device=cuda)
        parts = [torch.empty_like(x)]
        torch.cuda.synchronize()
        # switched outside the watched region: its first switch warns
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                dist.all_reduce(x, group=group)
                dist.all_gather(parts, x, group=group)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert not [str(w.message) for w in caught
                    if "synchroniz" in str(w.message)]
        want = torch.arange(64, dtype=torch.float32, device=cuda)
        assert torch.equal(x, want) and torch.equal(parts[0], want)
    finally:
        dist.destroy_process_group()
