"""The port's int8 KV pool against the reference's (DESIGN.md §13): the
quantization primitives bit for bit, the byte accounting, the quantized
pool's write/gather round trip, the plain version of the int8 paged
attention kernel against the Pallas kernel (interpret mode) and its
oracle, and the int8 serving engine's greedy streams and pool metrics
against the reference engine's, under preemption too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.kernels import ref
from repro.kernels.ragged_attention import paged_ragged_verify_attention_quant
from repro.models import cache as ref_cache
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.request import Request
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import spec_decode as t_sd
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.kernels import paged_attention_quant as t_quant
from repro_torch.models import cache as t_cache
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from _jax_caches import release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")


def _kv(seed, shape, zero_rows=True):
    """Seeded K/V-like values over several magnitudes, with some all-zero
    vectors (scale 1.0) among them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape[:-1], 1))).astype(np.float32)
    if zero_rows:
        x.reshape(-1, shape[-1])[::7] = 0.0
    return x


# ---------------------------------------------------------------------------
# Quantization primitives and byte accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((4, 7, 3, 64), 0), ((2, 11, 2, 32), 1),
                                        ((1, 5, 1, 16), 2)])
def test_quantize_kv_bit_identical_to_reference(shape, seed):
    x = _kv(seed, shape)
    q, s = t_cache.quantize_kv(torch.from_numpy(x))
    rq, rs = ref_cache.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    zero = np.all(x == 0.0, axis=-1)
    assert zero.any() and np.all(s.numpy()[zero] == 1.0)
    np.testing.assert_array_equal(
        t_cache.dequantize_kv(q, s).numpy(),
        np.asarray(ref_cache.dequantize_kv(rq, rs)))


def test_fake_quantize_kv_is_idempotent_and_matches_reference():
    x = torch.from_numpy(_kv(3, (3, 9, 2, 64)))
    f1 = t_cache.fake_quantize_kv(x)
    assert torch.equal(t_cache.fake_quantize_kv(f1), f1)
    np.testing.assert_array_equal(
        f1.numpy(), np.asarray(ref_cache.fake_quantize_kv(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("reduced", [True, False])
def test_kv_block_bytes_and_equal_byte_blocks_match_reference(reduced):
    cfg = get_config("smollm-135m")
    tcfg = t_get_config("smollm-135m")
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    for bs in (8, 16):
        for mode in ("none", "int8"):
            assert (t_cache.kv_block_bytes(tcfg, bs, mode)
                    == ref_cache.kv_block_bytes(cfg, bs, mode))
        for n in (16, 32, 64):
            assert (t_cache.equal_byte_blocks(tcfg, n, bs)
                    == ref_cache.equal_byte_blocks(cfg, n, bs))
    if not reduced:
        # full smollm-135m, block 16: 737 280 vs 195 840 bytes a block
        assert t_cache.kv_block_bytes(tcfg, 16, "none") == 737280
        assert t_cache.kv_block_bytes(tcfg, 16, "int8") == 195840
        assert t_cache.equal_byte_blocks(tcfg, 32, 16) == 120


def test_write_gather_roundtrip_keep_mask_and_unallocated():
    """Quantize-on-write then dequantizing gather gives fake_quantize of
    the written values; ``keep=False`` and unallocated entries write
    nothing (they land in the drop block, scales included)."""
    cfg = t_get_config("smollm-135m").reduced()
    kv, d = cfg.num_kv_heads, cfg.resolved_head_dim
    n, bs, b, t = 10, 4, 3, 6
    c = t_cache.paged_cache_struct(cfg, b, 32, n, bs, kv_quant="int8")
    assert c["k"].dtype == torch.int8
    assert tuple(c["k_scale"].shape) == (cfg.num_layers, n + 1, bs, kv)
    table = torch.full((b, 8), -1, dtype=torch.int32)
    table[0, :2] = torch.tensor([3, 7])
    table[1, :2] = torch.tensor([0, 5])
    table[2, 0] = 9                  # positions 4-5 of row 2 are unallocated
    pos = torch.arange(t, dtype=torch.int32)[None].repeat(b, 1)
    keep = torch.ones((b, t), dtype=torch.bool)
    keep[1, 2] = False
    k_new = torch.from_numpy(_kv(4, (b, t, kv, d)))
    v_new = torch.from_numpy(_kv(5, (b, t, kv, d)))
    slots = t_cache.write_slots(pos, table, bs, n + 1, keep=keep)
    layer = [c[name][1] for name in ("k", "v", "k_scale", "v_scale")]
    before = [x.clone() for x in layer]
    t_cache.write_kv_paged_quant(*layer, k_new, v_new, slots)
    gk, gv = t_cache.gather_paged_kv_quant(*layer, table)
    allocated = table.repeat_interleave(bs, 1)[:, :t] >= 0
    written = keep & allocated
    assert not bool(allocated[2, 4:].any())
    for got, new in ((gk, k_new), (gv, v_new)):
        got = got[:, :t]
        assert torch.equal(got[written], t_cache.fake_quantize_kv(new)[written])
        assert not bool(got[allocated & ~written].any())   # still zeros
    # the other layers and every block no write reached stay untouched
    assert not bool(c["k"][0].any()) and not bool(c["k_scale"][0].any())
    for blk in sorted(set(range(n)) - {3, 7, 0, 5, 9}):
        for x, y in zip(layer, before):
            assert torch.equal(x[blk], y[blk])
    # the reference's write, from the same empty pools, lands the same
    # values and scales (its dropped writes fall off the end)
    want = ref_cache.write_kv_paged_quant(
        *[jnp.asarray(x[:n].numpy()) for x in before],
        jnp.asarray(k_new.numpy()), jnp.asarray(v_new.numpy()),
        jnp.asarray(pos.numpy()), jnp.asarray(table.numpy()),
        keep=jnp.asarray(keep.numpy()))
    for got, w in zip(layer, want):
        np.testing.assert_array_equal(got[:n].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# B4's plain version against the Pallas kernel and its oracle
# ---------------------------------------------------------------------------

QUANT_SHAPES = [
    # b, t, h, kv, d, n_blocks, bs, maxb
    (3, 1, 9, 3, 64, 14, 16, 4),        # draft step, smollm grouping (G=3)
    (3, 11, 9, 3, 64, 14, 16, 4),       # verify at K+1 = 11
    (2, 6, 8, 8, 32, 12, 8, 5),         # MHA
]


def _quant_inputs(b, t, h, kv, d, n, bs, maxb, seed):
    """Ragged tables with a -1 hole mid-table; row 0 has NO allocated
    block (fully masked); int8 pools with their amax scales."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    kq, ks = ref_cache.quantize_kv(jnp.asarray(_kv(seed + 1, (n, bs, kv, d))))
    vq, vs = ref_cache.quantize_kv(jnp.asarray(_kv(seed + 2, (n, bs, kv, d))))
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
                continue
            table[i, lb] = perm[c]
            c += 1
            for s in range(bs):
                if lb * bs + s < ntok:
                    kvp[table[i, lb], s] = lb * bs + s
        qpos[i] = np.arange(ntok - t, ntok)
    qpos[0] = np.arange(t) + 5
    return (q, np.array(kq), np.array(vq), np.array(ks), np.array(vs),
            table, qpos, kvp)


def _has_valid_slot(table, qpos, kvp, window):
    """[B, T] bool: the query row sees at least one slot."""
    pos = np.where((table >= 0)[:, :, None], kvp[np.maximum(table, 0)], -1)
    pos = pos.reshape(table.shape[0], 1, -1)
    ok = (pos >= 0) & (pos <= qpos[:, :, None])
    if window is not None:
        ok &= qpos[:, :, None] - pos < window
    return ok.any(-1)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_plain_quant_attention_matches_pallas_and_oracle(shape, window):
    args = _quant_inputs(*shape, seed=sum(shape))
    got = t_quant.paged_ragged_verify_attention_quant_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args],
        window=window).numpy()
    jargs = [jnp.asarray(a) for a in args]
    kern = paged_ragged_verify_attention_quant(*jargs, window=window,
                                               interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=2e-5, rtol=1e-4)
    # the oracle softmaxes a row with no valid slot uniformly where the
    # kernel and the plain version give 0: compare the other rows
    want = np.asarray(ref.paged_ragged_verify_attention_quant_ref(
        *jargs, window=window))
    seen = _has_valid_slot(args[5], args[6], args[7], window)
    assert not seen[0].any() and seen.any()
    assert np.all(got[~seen] == 0.0)
    np.testing.assert_allclose(got[seen], want[seen], atol=2e-5, rtol=1e-4)


def test_cpu_dispatch_uses_plain_and_counts_no_launch():
    t_quant.LAUNCHES["paged_ragged_verify_attention_quant"] = 0
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in _quant_inputs(*QUANT_SHAPES[0], seed=3)]
    assert torch.equal(t_quant.paged_ragged_attention_quant(*args),
                       t_quant.paged_ragged_verify_attention_quant_plain(*args))
    assert t_quant.LAUNCHES["paged_ragged_verify_attention_quant"] == 0


# ---------------------------------------------------------------------------
# The int8 serving engine against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_pair():
    cfg = get_config("smollm-135m").reduced()
    pt = init_params(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    noise = init_params(model_specs(cfg), jax.random.PRNGKey(7), jnp.float32)
    pd = jax.tree_util.tree_map(lambda a, b: a + 0.05 * b, pt, noise)
    conv = lambda p: from_reference(jax.tree_util.tree_map(np.asarray, p),
                                    device="cpu")
    return cfg, pt, pd, t_get_config("smollm-135m").reduced(), conv(pt), conv(pd)


def _prompts(vocab, seed, lens):
    """Prompts that repeat a seeded phrase before a random tail, so the
    n-gram drafter's lookups hit."""
    rng = np.random.RandomState(seed)
    out = []
    for n in lens:
        phrase = rng.randint(0, vocab, size=4).tolist()
        out.append(phrase * 2 + rng.randint(0, vocab, size=n).tolist())
    return out


def serve_both(pair, drafter, policy, prompts, *, kv_quant, max_new=16,
               bs=16, nblocks=None, port_only=False):
    """The same requests through the port's and the reference's engines:
    returns ((port outputs, metrics, port engine), (reference outputs,
    metrics)); the second is None with ``port_only``."""
    cfg, pt, pd, tcfg, tpt, tpd = pair
    model = drafter == "model"
    # with random weights the streams never repeat a trigram; a 1-gram
    # lookup still finds earlier occurrences of the pending token
    sk = dict(policy=policy, drafter=drafter, ngram_n=1 if not model else 3)
    kw = dict(max_batch_size=2, max_seq_len=128, kv_block_size=bs,
              num_kv_blocks=nblocks, kv_quant=kv_quant, paged_kv=True)
    teng = TEngine(tpt, tcfg, tpd if model else None, tcfg if model else None,
                   TSpec(**sk), TServing(**kw),
                   device="cpu")
    treqs = [TRequest(i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    tm = teng.run(treqs)
    port = ([r.output for r in treqs], tm, teng)
    if port_only:
        return port, None
    eng = ServingEngine(pt, cfg, pd if model else None, cfg if model else None,
                        SpecDecodeConfig(**sk),
                        ServingConfig(**kw))
    reqs = [Request(i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    return port, ([r.output for r in reqs], m)


POOL_KEYS = ("kv_pool_blocks", "kv_block_bytes", "kv_pool_bytes", "kv_quant")


@pytest.mark.parametrize("policy", ["dsde", "static"])
@pytest.mark.parametrize("drafter", ["model", "ngram"])
def test_int8_greedy_streams_match_reference(small_pair, drafter, policy):
    prompts = _prompts(small_pair[0].vocab_size, 11, (7, 12, 5))
    (tout, tm, teng), (out, m) = serve_both(small_pair, drafter, policy,
                                            prompts, kv_quant="int8")
    assert tout == out
    assert sum(r["proposed"] for r in teng.round_log) > 0
    assert all(len(o) == 16 for o in tout)
    for key in ("rounds", "tokens_emitted", "draft_steps",
                "draft_steps_effective") + POOL_KEYS:
        assert tm[key] == m[key], key
    assert tm["kv_quant"] == "int8"


@pytest.mark.parametrize("drafter", ["model", "ngram"])
def test_int8_greedy_streams_match_reference_under_preemption(small_pair,
                                                              drafter):
    """A tight pool forces evict-and-requeue; the readmit recomputes the
    int8 KV (and, for the n-gram drafter, the history) of prompt +
    output, and the streams still equal the reference's."""
    prompts = _prompts(small_pair[0].vocab_size, 5, (30, 25, 20))
    nblocks = 16 if drafter == "model" else 8    # n-gram doubles its pool
    (tout, tm, _), (out, m) = serve_both(small_pair, drafter, "dsde",
                                         prompts, kv_quant="int8", max_new=40,
                                         bs=8, nblocks=nblocks)
    assert tm["preemptions"] >= 1
    assert tm["preemptions"] == m["preemptions"]
    assert tm["requests_finished"] == 3
    assert tout == out
    for key in POOL_KEYS:
        assert tm[key] == m[key], key


def test_int8_pool_costs_about_a_quarter_of_fp32(small_pair):
    """Same block count, the int8 pool's bytes (values + scales) at the
    reduced config: (D + 4) / (4 D) of the fp32 pool's."""
    prompts = _prompts(small_pair[0].vocab_size, 2, (5,))
    (_, fp, _), _ = serve_both(small_pair, "model", "dsde", prompts,
                               kv_quant="none", max_new=4, port_only=True)
    (_, q8, _), _ = serve_both(small_pair, "model", "dsde", prompts,
                               kv_quant="int8", max_new=4, port_only=True)
    d = small_pair[3].resolved_head_dim
    assert q8["kv_pool_blocks"] == fp["kv_pool_blocks"]
    assert q8["kv_pool_bytes"] * 4 * d == fp["kv_pool_bytes"] * (d + 4)


@pytest.mark.parametrize("where", ["engine", "round_state", "cache",
                                   "block_bytes", "family"])
def test_invalid_kv_quant_raises(small_pair, where):
    tcfg, tpt = small_pair[3], small_pair[4]
    with pytest.raises(ValueError):
        if where == "engine":
            TEngine(tpt, tcfg, tpt, tcfg, TSpec(),
                    TServing(max_batch_size=2, max_seq_len=64,
                             paged_kv=True, kv_quant="int4"), device="cpu")
        elif where == "round_state":
            t_sd.init_round_state(tcfg, tcfg, TSpec(), 2, 64, paged=(8, 16),
                                  device="cpu", kv_quant="fp8")
        elif where == "cache":
            t_cache.paged_cache_struct(tcfg, 2, 64, 8, 16, kv_quant="int4")
        elif where == "block_bytes":
            t_cache.kv_block_bytes(tcfg, 16, "int4")
        else:
            import dataclasses
            hybrid = dataclasses.replace(tcfg, family="hybrid")
            TEngine(tpt, tcfg, tpt, hybrid, TSpec(),
                    TServing(max_batch_size=2, max_seq_len=64,
                             paged_kv=True, kv_quant="int8"), device="cpu")
