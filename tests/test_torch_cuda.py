"""The port's CUDA kernels against their plain PyTorch versions, and the
serving path on the card against the CPU.  Needs a CUDA card (``gpu``
marker; each test skips without one) and imports nothing of JAX, so it
runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
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
@pytest.mark.parametrize("shape", [(4, 1, 9, 3, 64, 40, 16, 8),
                                   (4, 11, 9, 3, 64, 40, 16, 8),
                                   (3, 6, 8, 8, 32, 30, 8, 9),
                                   (2, 3, 4, 1, 128, 20, 32, 6)])
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
                                   (3, 6, 8, 8, 32, 30, 8, 9)])
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
