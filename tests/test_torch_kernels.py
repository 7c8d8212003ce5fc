"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's dispatchers take the plain PyTorch versions, which
are held here against the JAX Pallas kernels run in interpret mode and
against the reference's jnp oracles, on the same numpy inputs.  The CUDA
kernels themselves are held against the plain versions on the card in
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.kld_accept import fused_kld_accept
from repro.kernels.ragged_attention import (paged_ragged_verify_attention,
                                           ragged_verify_attention)
from repro_torch.kernels import kld_accept as t_kld
from repro_torch.kernels import paged_attention as t_attn
from repro_torch.kernels import ragged_attention as t_ring
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")

PAGED_SHAPES = [
    # b, t, h, kv, d, n_blocks, bs, maxb
    (3, 1, 9, 3, 64, 14, 16, 4),        # draft step, smollm grouping (G=3)
    (3, 11, 9, 3, 64, 14, 16, 4),       # verify at K+1 = 11
    (2, 6, 8, 8, 32, 12, 8, 5),         # MHA
    # recurrentgemma-2b's local attention (G 10 at D 256) and its draft's
    # (G 2 at D 320): the wide heads' kernel, draft step and verify
    (3, 1, 10, 1, 256, 14, 16, 4),
    (3, 11, 10, 1, 256, 14, 16, 4),
    (3, 1, 2, 1, 320, 14, 16, 4),
    (3, 11, 2, 1, 320, 14, 16, 4),
]


def _paged_inputs(b, t, h, kv, d, n, bs, maxb, seed):
    """Ragged tables with -1 holes; row 0 has NO allocated block (a
    fully masked row); pool-level kv_pos with empty (-1) slots."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    pk = rng.randn(n, bs, kv, d).astype(np.float32)
    pv = rng.randn(n, bs, kv, d).astype(np.float32)
    table = np.full((b, maxb), -1, np.int32)
    kvp = np.full((n, bs), -1, np.int32)
    qpos = np.zeros((b, t), np.int32)
    perm = rng.permutation(n)
    c = 0
    for i in range(1, b):
        nb = min(maxb, 1 + rng.randint(maxb))
        ntok = rng.randint(t, nb * bs + 1)
        for lb in range(nb):
            if lb == 1 and nb > 2:
                continue                  # an unallocated hole mid-table
            table[i, lb] = perm[c]
            c += 1
            for s in range(bs):
                p = lb * bs + s
                if p < ntok:
                    kvp[table[i, lb], s] = p
        qpos[i] = np.arange(ntok - t, ntok)
    qpos[0] = np.arange(t) + 5
    return q, pk, pv, table, qpos, kvp


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_plain_paged_attention_matches_pallas_and_oracle(shape, window):
    args = _paged_inputs(*shape, seed=sum(shape))
    got = t_attn.paged_ragged_verify_attention_plain(*_torch(*args),
                                                     window=window).numpy()
    jargs = [jnp.asarray(a) for a in args]
    kern = paged_ragged_verify_attention(*jargs, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=2e-5, rtol=1e-4)
    # the jnp oracle softmaxes a fully masked row uniformly where the
    # kernel (and the plain version) return 0: compare rows with a slot
    # (row 0 has none; with a window, a query whose window falls in the
    # table's hole has none either)
    want = np.asarray(ref.paged_ragged_verify_attention_ref(*jargs,
                                                            window=window))
    has_slot = _has_valid_slot(*args[3:], window)
    assert not has_slot[0].any()
    assert np.all(got[~has_slot] == 0.0)
    np.testing.assert_allclose(got[has_slot], want[has_slot], atol=2e-5,
                               rtol=1e-4)


def _has_valid_slot(table, q_pos, kv_pos, window):
    """[B,T] bool: the query has a slot with 0 <= kv_pos <= q_pos (and
    q_pos - kv_pos < window) among its table's blocks."""
    pos = np.where(table[:, :, None] >= 0, kv_pos[np.maximum(table, 0)], -1)
    pos = pos.reshape(table.shape[0], 1, -1)
    ok = (pos >= 0) & (pos <= q_pos[:, :, None])
    if window is not None:
        ok &= q_pos[:, :, None] - pos < window
    return ok.any(-1)


@pytest.mark.parametrize("b,t,v,bv", [(2, 3, 1000, 256), (4, 10, 1030, 512),
                                      (1, 1, 5003, 2048)])
def test_plain_kld_matches_pallas_and_oracle(b, t, v, bv):
    rng = np.random.RandomState(b * 100 + v)
    tl = (rng.randn(b, t, v) * 3).astype(np.float32)
    dl = (rng.randn(b, t, v) * 3).astype(np.float32)
    tok = rng.randint(0, v, size=(b, t)).astype(np.int32)
    got = t_kld.kld_accept_plain(*_torch(tl, dl, tok))
    kern = fused_kld_accept(jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(tok),
                            block_v=bv, interpret=True)
    want = ref.kld_accept_ref(jnp.asarray(tl), jnp.asarray(dl),
                              jnp.asarray(tok))
    for g, k, w, name in zip(got, kern, want, ("kld", "ent", "ptok", "qtok")):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("window", [None, 24])
def test_ring_split_plain_matches_pallas(window):
    """B5's algorithm (live-chunk skip, splits merged in order) against
    the reference Pallas kernel in interpret mode: a partial ring (one
    empty row, rows of 1, 20 and 61 positions), W 80 (no multiple of 64),
    G 3, T 4, forced S 1, 3 and 8 (past the ring's 5 chunks)."""
    rng = np.random.RandomState(15)
    b, t, h, kv, d, w = 4, 4, 9, 3, 64, 80
    q = rng.randn(b, t, h, d).astype(np.float32)
    kb = rng.randn(b, w, kv, d).astype(np.float32)
    vb = rng.randn(b, w, kv, d).astype(np.float32)
    n = np.array([0, 1, 20, 61])
    j = np.arange(w)[None]
    kvp = np.where(j < n[:, None], j, -1).astype(np.int32)
    qp = (np.maximum(n - t, 0)[:, None] + np.arange(t)[None]).astype(np.int32)
    kern = np.asarray(ragged_verify_attention(
        *(jnp.asarray(x) for x in (q, kb, vb, qp, kvp)), window=window,
        interpret=True))
    for splits in (1, 3, 8):
        got = t_ring.ragged_verify_attention_split_plain(
            *_torch(q, kb, vb, qp, kvp), window=window, splits=splits).numpy()
        np.testing.assert_allclose(got, kern, atol=2e-5, rtol=1e-4)
        assert np.all(got[0] == 0.0)


def _kld_exact(tl, dl):
    """KL and H of each row in float64, from the log_softmax sums."""
    lp = torch.log_softmax(torch.from_numpy(tl).double(), -1)
    lq = torch.log_softmax(torch.from_numpy(dl).double(), -1)
    return (lp.exp() * (lp - lq)).sum(-1), -(lq.exp() * lq).sum(-1)


@pytest.mark.parametrize("b,t,v", [(2, 3, 49280), (4, 10, 1030),
                                   (1, 3, 77)])
def test_kld_split_plain_matches_plain_and_pallas(b, t, v):
    """B2's chunked algorithm (chunk states merged in chunk order) at the
    planned C and forced C 1, 3 and 8, tokens inside and outside [0, V):
    against the Pallas kernel in interpret mode and a float64 evaluation
    at atol 1e-5; against ``kld_accept_plain`` at atol 1e-5 for V 1030
    and 77, and at V 49280 within the plain version's own float32 error
    there (up to 1.5e-5 from float64 for KL near 9 nats) plus 1e-5."""
    rng = np.random.RandomState(b * 100 + v)
    tl = (rng.randn(b, t, v) * 3).astype(np.float32)
    dl = (rng.randn(b, t, v) * 3).astype(np.float32)
    tok = rng.randint(0, v, size=(b, t)).astype(np.int32)
    tok[0, 0], tok[-1, -1] = -1, v
    kern = [np.asarray(x) for x in fused_kld_accept(
        jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(tok), interpret=True)]
    plain = [x.numpy() for x in t_kld.kld_accept_plain(*_torch(tl, dl, tok))]
    exact = [x.numpy() for x in _kld_exact(tl, dl)]
    assert plain[2][0, 0] == 0.0 and plain[3][-1, -1] == 0.0
    plain_err = max(np.abs(plain[i] - exact[i]).max() for i in (0, 1))
    for chunks in (None, 1, 3, 8):
        got = [x.numpy() for x in t_kld.kld_accept_split_plain(
            *_torch(tl, dl, tok), chunks=chunks)]
        for i, name in enumerate(("kld", "ent", "ptok", "qtok")):
            np.testing.assert_allclose(got[i], kern[i], atol=1e-5,
                                       err_msg=name)
            atol = 1e-5 if v < 49280 or i > 1 else 1e-5 + plain_err
            np.testing.assert_allclose(got[i], plain[i], atol=atol,
                                       err_msg=name)
        for i in (0, 1):
            np.testing.assert_allclose(got[i], exact[i], atol=1e-5)


def test_kld_split_ranges_cover_each_row_once():
    """The kernel's chunks of a row: every logit once, in order, the head
    in chunk 0 and the tail in the last chunk, for vector and scalar
    rows, and C = kld_chunks picks 8 at the round's 40 rows."""
    assert t_kld.kld_chunks(40, 49280) == 8
    assert t_kld.kld_chunks(1, 77) == 1
    assert t_kld.kld_chunks(396, 49280) == 1
    for v in (1, 5, 77, 1030, 49280):
        for head, width in ((0, 4), (3, 4), (1, 4), (0, 1)):
            head = min(head, v)
            for c in (1, 2, 3, 8):
                ranges = t_kld.kld_split_ranges(v, c, head, width)
                assert len(ranges) == c
                assert [i for lo, hi in ranges for i in range(lo, hi)] == \
                    list(range(v))
                for lo, hi in ranges[1:-1]:
                    assert (lo - head) % width == 0 and (hi - head) % width == 0
    assert t_kld.row_units(0, 4, 10) == (0, 1)       # unlike modulo 16 bytes
    assert t_kld.row_units(4, 20, 10) == (3, 4)      # alike, 3 before 16
    assert t_kld.row_units(32, 64, 10) == (0, 4)


def test_cpu_dispatch_uses_plain_and_counts_no_launch():
    t_attn.LAUNCHES["paged_ragged_verify_attention"] = 0
    t_kld.LAUNCHES["fused_kld_accept"] = 0
    args = _torch(*_paged_inputs(*PAGED_SHAPES[0], seed=3))
    got = t_attn.paged_ragged_attention(*args)
    want = t_attn.paged_ragged_verify_attention_plain(*args)
    assert torch.equal(got, want)
    tl, dl = torch.randn(2, 3, 300), torch.randn(2, 3, 300)
    tok = torch.randint(0, 300, (2, 3), dtype=torch.int32)
    for g, w in zip(t_kld.kld_accept_signals(tl, dl, tok),
                    t_kld.kld_accept_plain(tl, dl, tok)):
        assert torch.equal(g, w)
    assert t_attn.LAUNCHES["paged_ragged_verify_attention"] == 0
    assert t_kld.LAUNCHES["fused_kld_accept"] == 0
