"""The port's CUDA kernels against their plain PyTorch versions, and the
serving path on the card against the CPU.  Needs a CUDA card (``gpu``
marker; each test skips without one) and imports nothing of JAX, so it
runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import kld_accept as kl
from repro_torch.kernels import paged_attention as pa

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


def test_dispatch_counts_launches_on_cuda(cuda):
    pa.LAUNCHES["paged_ragged_verify_attention"] = 0
    kl.LAUNCHES["fused_kld_accept"] = 0
    args = _paged(2, 1, 9, 3, 64, 10, 16, 4, torch.float32, cuda)
    pa.paged_ragged_attention(*args)
    x = torch.randn(1, 2, 50, device=cuda)
    kl.kld_accept_signals(x, x, torch.zeros((1, 2), dtype=torch.int32,
                                            device=cuda))
    assert pa.LAUNCHES["paged_ragged_verify_attention"] == 1
    assert kl.LAUNCHES["fused_kld_accept"] == 1
    with pytest.raises(TypeError):      # int64 tables: raise, no fallback
        pa.paged_ragged_attention(*args[:3], args[3].long(), *args[4:])


def test_engine_streams_match_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = get_config("smollm-135m").reduced()
    pt = init_params(cfg, seed=2, device="cpu")
    pd = map_params(lambda a, n: a + 0.03 * n, pt,
                    init_params(cfg, seed=3, device="cpu"))
    outs = []
    for device in ("cpu", cuda):
        reqs = [Request(i, prompt=list(range(5 + i, 14 + 3 * i)),
                        max_new_tokens=20) for i in range(3)]
        ServingEngine(pt, cfg, pd, cfg, SpecDecodeConfig(),
                      ServingConfig(max_batch_size=2, max_seq_len=96,
                                    kv_block_size=16),
                      device=device).run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
