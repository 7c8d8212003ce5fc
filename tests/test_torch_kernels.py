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
from repro.kernels.ragged_attention import paged_ragged_verify_attention
from repro_torch.kernels import kld_accept as t_kld
from repro_torch.kernels import paged_attention as t_attn
from _jax_caches import release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")

PAGED_SHAPES = [
    # b, t, h, kv, d, n_blocks, bs, maxb
    (3, 1, 9, 3, 64, 14, 16, 4),        # draft step, smollm grouping (G=3)
    (3, 11, 9, 3, 64, 14, 16, 4),       # verify at K+1 = 11
    (2, 6, 8, 8, 32, 12, 8, 5),         # MHA
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
    want = np.asarray(ref.paged_ragged_verify_attention_ref(*jargs,
                                                            window=window))
    assert np.all(got[0] == 0.0)
    np.testing.assert_allclose(got[1:], want[1:], atol=2e-5, rtol=1e-4)


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
