"""The port's dense KV ring against the reference's: the ragged verify
attention kernel's plain version (B5) against the Pallas kernel in
interpret mode and the jnp oracle, the ring writes, the dense-ring
prefill/decode logits (with and without a window whose ring wraps), and
the ring contents a bucket-padded prefill leaves behind.  The CUDA
kernel itself is held against the plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import prefill as ref_prefill
from repro.kernels import ref
from repro.kernels.ragged_attention import ragged_verify_attention
from repro.models import cache as ref_cache
from repro.models.module import init_params as ref_init
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import prefill as t_prefill
from repro_torch.kernels import ragged_attention as t_ra
from repro_torch.models import cache as t_cache
from repro_torch.models.transformer import forward
from repro_torch.models.weights import from_reference
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")
ATOL = 1e-4

# the reference's own sweep (tests/test_kernels.py): b, t, h, kv, d, w
SHAPES = [
    (2, 1, 8, 2, 64, 128),      # plain decode, GQA 4x
    (3, 6, 8, 8, 64, 256),      # verify, MHA
    (2, 11, 12, 4, 128, 96),    # verify, SL_max+1 queries
    (1, 4, 4, 1, 32, 512),      # MQA
    (2, 3, 16, 16, 64, 160),    # non-pow2 ring
    # recurrentgemma-2b's local attention (G 10 at D 256) and its draft's
    # (G 2 at D 320): the wide heads' kernel, draft step and verify
    (2, 1, 10, 1, 256, 80),
    (2, 11, 10, 1, 256, 80),
    (2, 1, 2, 1, 320, 80),
    (2, 11, 2, 1, 320, 80),
]


def _ring_inputs(b, t, h, kv, d, w, seed=0, wrap=False):
    """Ring rows holding positions [0, len + t); with ``wrap`` each row
    has run past W, so slot j holds the latest position p = j (mod W)
    below len + t, and older slots are overwritten."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    kb = rng.randn(b, w, kv, d).astype(np.float32)
    vb = rng.randn(b, w, kv, d).astype(np.float32)
    if wrap:
        lens = rng.randint(w, 3 * w, size=b)
    else:
        lens = rng.randint(t, max(w - t, t + 1), size=b)
    q_pos = (lens[:, None] + np.arange(t)[None]).astype(np.int32)
    end = lens + t                                   # positions [0, end)
    j = np.arange(w)[None]
    latest = j + w * ((end[:, None] - 1 - j) // w)   # largest p = j mod W
    kv_pos = np.where(latest >= 0, latest, -1).astype(np.int32)
    return q, kb, vb, q_pos, kv_pos


def _pallas(q, kb, vb, q_pos, kv_pos, window, dtype=jnp.float32, block_k=64):
    args = [jnp.asarray(x) for x in (q, kb, vb, q_pos, kv_pos)]
    args[:3] = [x.astype(dtype) for x in args[:3]]
    return ragged_verify_attention(*args, window=window, interpret=True,
                                   block_k=block_k)


def _oracle(q, kb, vb, q_pos, kv_pos, window):
    return ref.ragged_verify_attention_ref(
        *(jnp.asarray(x) for x in (q, kb, vb, q_pos, kv_pos)), window=window)


def _plain(q, kb, vb, q_pos, kv_pos, window, dtype=torch.float32):
    t = [torch.from_numpy(x) for x in (q, kb, vb, q_pos, kv_pos)]
    t[:3] = [x.to(dtype) for x in t[:3]]
    return t_ra.ragged_verify_attention_plain(*t, window=window)


# ---------------------------------------------------------------------------
# B5: the plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_oracle(shape, window):
    args = _ring_inputs(*shape)
    got = _plain(*args, window).numpy()
    np.testing.assert_allclose(got, np.asarray(_pallas(*args, window)),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(_oracle(*args, window)),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("window", [None, 64])
def test_plain_matches_pallas_on_a_wrapped_ring(window):
    """Rows that have run past W (positions up to 3W): the ring holds the
    latest W positions; with a window some of them fall outside it."""
    args = _ring_inputs(3, 11, 9, 3, 64, 80, seed=4, wrap=True)
    got = _plain(*args, window).numpy()
    np.testing.assert_allclose(got, np.asarray(_pallas(*args, window)),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(_oracle(*args, window)),
                               atol=2e-5, rtol=1e-4)


def test_plain_bf16_matches_pallas():
    """bf16 operands, accumulated in fp32 on both sides (the reference's
    own bf16 tolerance)."""
    args = _ring_inputs(2, 4, 8, 4, 64, 128, seed=1)
    got = _plain(*args, None, dtype=torch.bfloat16)
    want = _pallas(*args, None, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=1e-2)


def test_plain_empty_cache_rows():
    """Rings holding only the freshly written tokens; queries with no
    valid slot at all give 0, as the Pallas kernel's do."""
    b, t, h, kv, d, w = 2, 2, 4, 2, 32, 64
    rng = np.random.RandomState(2)
    q = rng.randn(b, t, h, d).astype(np.float32)
    kb = rng.randn(b, w, kv, d).astype(np.float32)
    vb = rng.randn(b, w, kv, d).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(t)[None], (b, t)).astype(np.int32).copy()
    kv_pos = np.where(np.arange(w)[None] < t, np.arange(w)[None],
                      -1).repeat(b, 0).astype(np.int32)
    got = _plain(q, kb, vb, q_pos, kv_pos, None).numpy()
    np.testing.assert_allclose(got, np.asarray(_pallas(
        q, kb, vb, q_pos, kv_pos, None, block_k=32)), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_oracle(
        q, kb, vb, q_pos, kv_pos, None)), atol=2e-5)
    kv_pos[1] = -1                                  # row 1: nothing valid
    got = _plain(q, kb, vb, q_pos, kv_pos, None).numpy()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got, np.asarray(_pallas(
        q, kb, vb, q_pos, kv_pos, None, block_k=32)), atol=2e-5)


def test_cpu_dispatch_reaches_the_plain_version(monkeypatch):
    args = [torch.from_numpy(x) for x in _ring_inputs(1, 2, 4, 2, 32, 64)]
    want = t_ra.ragged_verify_attention_plain(*args)
    before = dict(t_ra.LAUNCHES)
    calls = []

    def plain(*a, **kw):
        calls.append(a)
        return want

    monkeypatch.setattr(t_ra, "ragged_verify_attention_plain", plain)
    got = t_ra.ragged_attention(*args)
    assert len(calls) == 1 and got is want
    assert t_ra.LAUNCHES == before                  # no kernel launch counted
    with pytest.raises(ValueError, match="CUDA"):
        t_ra.ragged_verify_attention_cuda(*args)


# ---------------------------------------------------------------------------
# the ring: structure and writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 24, 500])
def test_cache_struct_matches_reference(window):
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              attention_window=window)
    tcfg = dataclasses.replace(t_get_config("smollm-135m").reduced(),
                               attention_window=window)
    rc = ref_cache.cache_struct(cfg, 3, 96, jnp.float32)
    tc = t_cache.cache_struct(tcfg, 3, 96)
    assert set(tc) == set(rc) == {"length", "k", "v", "kv_pos"}
    for key in rc:
        assert tuple(tc[key].shape) == tuple(rc[key].shape), key
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(rc[key]))
    assert t_cache.cache_window(tc) == ref_cache.cache_window(rc)


@pytest.mark.parametrize("t,start", [(3, 5),      # inside the ring
                                     (5, 14),     # wraps past W
                                     (16, 2),     # t == W
                                     (23, 9)])    # t > W: the last W kept
def test_write_kv_and_pos_match_reference(t, start):
    b, w, kv, d = 2, 16, 2, 8
    rng = np.random.RandomState(t)
    k_buf = rng.randn(b, w, kv, d).astype(np.float32)
    v_buf = rng.randn(b, w, kv, d).astype(np.float32)
    kv_pos = rng.randint(-1, 40, size=(b, w)).astype(np.int32)
    k_new = rng.randn(b, t, kv, d).astype(np.float32)
    v_new = rng.randn(b, t, kv, d).astype(np.float32)
    pos = (np.array([[start], [start + 7]]) + np.arange(t)[None]).astype(np.int32)
    valid = rng.rand(b, t) > 0.3
    rk, rv = ref_cache.write_kv(*(jnp.asarray(x) for x in
                                  (k_buf, v_buf, k_new, v_new, pos)))
    rp = ref_cache.write_pos(jnp.asarray(kv_pos), jnp.asarray(pos),
                             jnp.asarray(valid))
    tk, tv, tp = (torch.from_numpy(x.copy()) for x in (k_buf, v_buf, kv_pos))
    slots = t_cache.ring_slots(torch.from_numpy(pos), w)
    t_cache.write_kv(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                     slots)
    t_cache.write_pos(tp, torch.from_numpy(pos), slots, torch.from_numpy(valid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))


# ---------------------------------------------------------------------------
# the model over the ring
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = get_config("smollm-135m").reduced()
    params = ref_init(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    tparams = from_reference(jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")
    return cfg, params, t_get_config("smollm-135m").reduced(), tparams


@pytest.mark.parametrize("window", [None, 8])
def test_dense_logits_match_reference(model, window):
    """Prefill, then draft steps and K+1 verify passes on the ring, on
    both packages; with window 8 the ring is 24 slots and the decode
    steps run it past W, so it wraps."""
    cfg, params, tcfg, tparams = model
    cfg = dataclasses.replace(cfg, attention_window=window)
    tcfg = dataclasses.replace(tcfg, attention_window=window)
    rng = np.random.RandomState(3)
    lens = np.array([9, 5, 13])
    toks = rng.randint(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    mask = np.arange(16)[None] < lens[:, None]
    rc = ref_cache.cache_struct(cfg, 3, 64, jnp.float32)
    rl, rc, _ = ref_forward(params, cfg, jnp.asarray(toks), cache=rc,
                            mode="prefill", input_mask=jnp.asarray(mask))
    rc["length"] = jnp.asarray(lens, jnp.int32)
    tc = t_cache.cache_struct(tcfg, 3, 64)
    tl, tc = forward(tparams, tcfg, torch.from_numpy(toks), cache=tc,
                     mode="prefill", input_mask=torch.from_numpy(mask))
    tc["length"] = torch.from_numpy(lens.astype(np.int32))
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(rl)[mask],
                               atol=ATOL)
    for t in (1, 5, 1, 11, 1, 5):     # draft steps and K+1 verify passes
        nxt = rng.randint(0, cfg.vocab_size, size=(3, t)).astype(np.int32)
        rl, rc, _ = ref_forward(params, cfg, jnp.asarray(nxt), cache=rc,
                                mode="decode")
        tl, tc = forward(tparams, tcfg, torch.from_numpy(nxt), cache=tc,
                         mode="decode")
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=ATOL)
        np.testing.assert_array_equal(tc["kv_pos"].numpy(),
                                      np.asarray(rc["kv_pos"]))
        rc["length"] = rc["length"] + t
        tc["length"] = tc["length"] + t
    if window is not None:
        assert int(tc["length"].min()) > t_cache.cache_window(tc)  # wrapped


@pytest.mark.parametrize("lens", [(20, 70), (9, 33)])
def test_bucket_padded_prefill_keeps_the_reference_ring(model, lens):
    """The engine pads a prefill group to the reference's prompt bucket.
    Window 64 makes the ring 80 slots: a 70-token prompt pads to 128 >=
    W, and both packages keep the padded wave's last 80 columns, so
    positions below 48 never reach the ring (and the 20-token row of the
    same wave keeps none of its tokens below 48 either)."""
    cfg, params, tcfg, tparams = model
    cfg = dataclasses.replace(cfg, attention_window=64)
    tcfg = dataclasses.replace(tcfg, attention_window=64)
    bucket = 16
    while bucket < max(lens):
        bucket *= 2
    rng = np.random.RandomState(sum(lens))
    toks = np.zeros((2, bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, cfg.vocab_size, size=n)
    plens = np.asarray(lens, np.int32)
    rrows, rlast = ref_prefill.prefill_rows(params, cfg, jnp.asarray(toks),
                                            jnp.asarray(plens), 128)
    trows, tlast = t_prefill.prefill_rows(tparams, tcfg, torch.from_numpy(toks),
                                          torch.from_numpy(plens), 128)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(rlast), atol=ATOL)
    np.testing.assert_array_equal(trows["kv_pos"].numpy(),
                                  np.asarray(rrows["kv_pos"]))
    # ring K are raw activations (|k| up to ~25 at this init) summed over
    # d in another order: absolute error relative to the largest |k|
    rk = np.asarray(rrows["k"])
    np.testing.assert_allclose(trows["k"].numpy(), rk,
                               atol=ATOL * np.abs(rk).max(), rtol=1e-3)
    kept = trows["kv_pos"].numpy()
    lowest = max(0, bucket - 80)
    assert sorted(kept[1][kept[1] >= 0]) == list(range(lowest, lens[1]))
    # scattered into a batched ring at slots (2, 0), rows and lengths land
    big = t_cache.cache_struct(tcfg, 3, 128)
    big["kv_pos"].fill_(7)
    out = t_prefill.set_slots(big, trows, torch.tensor([2, 0]))
    assert out["length"].tolist() == [lens[1], 0, lens[0]]
    assert big["length"].tolist() == [0, 0, 0]       # the old dict untouched
    np.testing.assert_array_equal(out["kv_pos"][2].numpy(), kept[0])
    np.testing.assert_array_equal(out["kv_pos"][1].numpy(), 7)
    torch.testing.assert_close(out["v"][:, 0], trows["v"][:, 1])
