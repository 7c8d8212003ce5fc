"""The port's n-gram drafter against the reference's: the plain version
of the suffix-match kernel integer-exact against the Pallas kernel
(interpret mode) and its oracle, the drafter's propose / commit on the
same inputs, the fp32-pool serving engine's greedy streams, and the
model-free drafter's doubled block pool."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.core.drafters import build_drafter as ref_build_drafter
from repro.kernels import ref
from repro.kernels.ngram_match import ngram_suffix_propose
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.request import Request
from repro.serving.scheduler import LookaheadScheduler as RefScheduler
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.core.drafters import build_drafter as t_build_drafter
from repro_torch.kernels import ngram_match as t_ngram
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.scheduler import LookaheadScheduler
from _jax_caches import release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")


def _plain(buf, ctx, n, k):
    toks, cnt = t_ngram.ngram_propose_plain(
        torch.from_numpy(np.asarray(buf, np.int32)),
        torch.from_numpy(np.asarray(ctx, np.int32)), n=n, k=k)
    assert toks.dtype == torch.int32 and cnt.dtype == torch.int32
    return toks.numpy(), cnt.numpy()


# ---------------------------------------------------------------------------
# B3's plain version: integer-exact against the Pallas kernel and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1, 3), (2, 4), (3, 10), (4, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_ngram_matches_pallas_and_oracle_exactly(n, k, seed):
    rng = np.random.RandomState(seed)
    b, l = 6, 96
    # a small alphabet gives plenty of accidental repeats to find
    buf = rng.randint(0, 3, size=(b, l)).astype(np.int32)
    ctx = rng.randint(0, l + 1, size=(b,)).astype(np.int32)
    ctx[:3] = (n, n + 1, l)          # too short, just long enough, full row
    buf[2, 10:10 + n] = buf[2, l - n:]   # the full row's suffix recurs
    got_t, got_c = _plain(buf, ctx, n, k)
    for want_t, want_c in (
            ngram_suffix_propose(jnp.asarray(buf), jnp.asarray(ctx), n=n, k=k,
                                 interpret=True),
            ref.ngram_propose_ref(jnp.asarray(buf), jnp.asarray(ctx), n=n, k=k)):
        np.testing.assert_array_equal(got_t, np.asarray(want_t))
        np.testing.assert_array_equal(got_c, np.asarray(want_c))
    assert got_c.max() > 0           # the case exercises real matches


EDGE_CASES = {
    # buf, ctx, n, k, proposed, count (the oracle cases of
    # tests/test_drafters.py)
    # [1,2,3] occurs at 0 and 4; the most recent usable one is i=4
    "basic": ([1, 2, 3, 9, 1, 2, 3, 7, 5, 1, 2, 3, 0, 0], 12, 3, 4,
              [7, 5, 1, 2], 4),
    "no_match": ([1, 2, 3, 4, 5, 6, 0, 0], 6, 3, 2, [0, 0], 0),
    "short_ctx": ([1, 2, 3, 4, 5, 6, 0, 0], 3, 3, 2, [0, 0], 0),
    # i=2 continues with positions 4, 5 only: clipped at ctx
    "clipped": ([1, 2, 1, 2, 1, 2, 0, 0], 6, 2, 4, [1, 2, 0, 0], 2),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_plain_ngram_edge_cases(case):
    buf, ctx, n, k, want_t, want_c = EDGE_CASES[case]
    toks, cnt = _plain([buf], [ctx], n, k)
    assert toks.tolist() == [want_t] and cnt.tolist() == [want_c]
    ref_t, ref_c = ref.ngram_propose_ref(jnp.asarray([buf], jnp.int32),
                                         jnp.asarray([ctx]), n=n, k=k)
    np.testing.assert_array_equal(toks, np.asarray(ref_t))
    np.testing.assert_array_equal(cnt, np.asarray(ref_c))


def test_plain_ngram_k_zero_is_empty():
    buf = np.ones((3, 10), np.int32)
    toks, cnt = _plain(buf, [10, 4, 0], 2, 0)
    want_t, want_c = ngram_suffix_propose(jnp.asarray(buf),
                                          jnp.asarray([10, 4, 0]), n=2, k=0)
    assert toks.shape == np.asarray(want_t).shape == (3, 0)
    np.testing.assert_array_equal(cnt, np.asarray(want_c))


def test_cpu_dispatch_uses_plain_and_counts_no_launch():
    t_ngram.LAUNCHES["ngram_suffix_propose"] = 0
    buf = torch.randint(0, 4, (3, 40), dtype=torch.int32)
    ctx = torch.tensor([40, 7, 2], dtype=torch.int32)
    for got, want in zip(t_ngram.ngram_propose(buf, ctx, n=2, k=5),
                         t_ngram.ngram_propose_plain(buf, ctx, n=2, k=5)):
        assert torch.equal(got, want)
    assert t_ngram.LAUNCHES["ngram_suffix_propose"] == 0


@pytest.mark.parametrize("n,k", [(1, 4), (3, 10)])
@pytest.mark.parametrize("seed", [0, 1])
def test_history_plain_equals_oracle_of_the_overlaid_buffer(n, k, seed):
    """The drafter's entry: the oracle of the reference drafter's overlay
    (``buf.at[bi, ln].set(pending, mode="drop")``, ``min(ln + 1, h)``) at
    length 0, mid-row, L - 1 and L (the dropped write), with stale random
    text past each length."""
    rng = np.random.RandomState(seed)
    b, l = 6, 64
    buf = rng.randint(0, 3, size=(b, l)).astype(np.int32)
    length = np.array([0, l // 2, l - 1, l, n, rng.randint(0, l)], np.int32)
    pending = rng.randint(0, 3, size=(b,)).astype(np.int32)
    toks, cnt = t_ngram.ngram_propose_history_plain(
        torch.from_numpy(buf), torch.from_numpy(length),
        torch.from_numpy(pending), n=n, k=k)
    ln = jnp.asarray(length)
    work = jnp.asarray(buf).at[jnp.arange(b), ln].set(jnp.asarray(pending),
                                                      mode="drop")
    want_t, want_c = ref.ngram_propose_ref(work, jnp.minimum(ln + 1, l),
                                           n=n, k=k)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_c))
    assert np.asarray(want_c).max() > 0
    # the CPU dispatcher is the plain version
    for got, want in zip(t_ngram.ngram_propose_history(
            torch.from_numpy(buf), torch.from_numpy(length),
            torch.from_numpy(pending), n=n, k=k), (toks, cnt)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The drafter on the same inputs
# ---------------------------------------------------------------------------

def test_ngram_drafter_propose_commit_match_reference():
    cfg = get_config("smollm-135m").reduced()
    tcfg = t_get_config("smollm-135m").reduced()
    spec = SpecDecodeConfig(drafter="ngram", ngram_n=2)
    rd = ref_build_drafter(spec, cfg)
    td = t_build_drafter(TSpec(drafter="ngram", ngram_n=2), tcfg)
    assert td.step_cost() == 0.0 and not td.mirrors_kv()
    assert not td.uses_draft_model()
    b, h, k = 4, 24, 5
    rng = np.random.RandomState(3)
    prompts = rng.randint(0, 6, size=(b, 16)).astype(np.int32)
    plens = np.array([16, 9, 3, 12], np.int32)
    idx = np.array([2, 0, 3, 1])
    rc = rd.init_cache(b, h)
    tc = td.init_cache(b, h, paged=(8, 16))
    rc = rd.prefill(None, rc, jnp.asarray(idx), jnp.asarray(prompts),
                    jnp.asarray(plens), max_len=h)
    tc = td.prefill(None, tc, torch.from_numpy(idx), torch.from_numpy(prompts),
                    torch.from_numpy(plens), None)
    pending = np.array([3, 1, 4, 2], np.int32)
    sl = np.array([5, 5, 0, 3], np.int32)
    for _ in range(3):                   # three rounds of propose + commit
        rp = rd.propose(None, None, rc, None, jnp.asarray(pending), k,
                        jnp.asarray(sl), None, None, jnp.ones((b,), bool))
        tp = td.propose(None, tc, torch.from_numpy(pending), k,
                        torch.from_numpy(sl), None, None,
                        torch.ones((b,), dtype=torch.bool))
        np.testing.assert_array_equal(tp.tokens.numpy(), np.asarray(rp.tokens))
        np.testing.assert_array_equal(tp.eff_sl.numpy(), np.asarray(rp.eff_sl))
        np.testing.assert_array_equal(tp.logits.numpy(), np.asarray(rp.logits))
        assert tp.logits.shape[-1] == tcfg.padded_vocab(128)
        verify = np.concatenate([pending[:, None],
                                 np.asarray(rp.tokens)], 1).astype(np.int32)
        n_com = np.minimum(1 + np.asarray(rp.eff_sl), [2, 6, 1, 3]).astype(np.int32)
        rc = rd.commit(None, jnp.asarray(verify), rc, rp.cache,
                       jnp.asarray(n_com))
        tc = td.commit(torch.from_numpy(verify), tc, tp.cache,
                       torch.from_numpy(n_com))
        for key in ("tokens", "length"):
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(rc[key]))
        pending = rng.randint(0, 6, size=(b,)).astype(np.int32)
    rows = np.array([False, True, False, True])
    for key, val in td.reset_rows(tc, torch.from_numpy(rows)).items():
        np.testing.assert_array_equal(
            val.numpy(), np.asarray(rd.reset_rows(rc, jnp.asarray(rows))[key]))
    # -log p_target(token) where valid, 0 elsewhere
    tl = rng.randn(b, k, 640).astype(np.float32)
    tok = rng.randint(0, 512, size=(b, k)).astype(np.int32)
    valid = rng.rand(b, k) < 0.6
    np.testing.assert_allclose(
        td.observation_kld(torch.from_numpy(tl), None, torch.from_numpy(tok),
                           torch.from_numpy(valid)).numpy(),
        np.asarray(rd.observation_kld(jnp.asarray(tl), None, jnp.asarray(tok),
                                      jnp.asarray(valid))), atol=1e-5)


# ---------------------------------------------------------------------------
# The fp32-pool engine with the n-gram drafter against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def targets():
    """Reference and port weights of two targets: ``random`` (seeded
    init; its streams never repeat a trigram, so it serves with 1-gram
    lookups: proposals, mostly rejected) and ``copy`` (the residual
    branches zeroed, so greedy repeats its first token: trigram lookups
    hit and are accepted in full)."""
    cfg = get_config("smollm-135m").reduced()
    rand = init_params(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    copy = jax.tree_util.tree_map(lambda a: a, rand)
    for block, leaf in (("attn", "wo"), ("mlp", "w_down")):
        copy["layers"][block][leaf] = jnp.zeros_like(rand["layers"][block][leaf])
    conv = lambda p: from_reference(jax.tree_util.tree_map(np.asarray, p),
                                    device="cpu")
    return cfg, t_get_config("smollm-135m").reduced(), {
        "random": (rand, conv(rand), 1), "copy": (copy, conv(copy), 3)}


@pytest.mark.parametrize("target", ["random", "copy"])
@pytest.mark.parametrize("policy", ["dsde", "static", "autoregressive"])
def test_fp32_ngram_greedy_streams_match_reference(targets, policy, target):
    cfg, tcfg, weights = targets
    pt, tpt, n = weights[target]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, size=m).tolist()
               for m in (7, 12, 5)]
    kw = dict(max_batch_size=2, max_seq_len=128, kv_block_size=16,
              paged_kv=True)
    teng = TEngine(tpt, tcfg, None, None,
                   TSpec(policy=policy, drafter="ngram", ngram_n=n),
                   TServing(**kw), device="cpu")
    treqs = [TRequest(i, prompt=p, max_new_tokens=16)
             for i, p in enumerate(prompts)]
    tm = teng.run(treqs)
    eng = ServingEngine(pt, cfg, None, None,
                        SpecDecodeConfig(policy=policy, drafter="ngram",
                                         ngram_n=n),
                        ServingConfig(**kw))
    reqs = [Request(i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    assert [r.output for r in treqs] == [r.output for r in reqs]
    assert all(len(r.output) == 16 for r in treqs)
    for key in ("rounds", "tokens_emitted", "draft_steps",
                "draft_steps_effective", "kv_pool_blocks", "kv_pool_bytes"):
        assert tm[key] == m[key], key
    proposed = sum(r["proposed"] for r in teng.round_log)
    accepted = sum(r["accepted"] for r in teng.round_log)
    if policy != "autoregressive":
        assert proposed > 0
        assert (accepted == proposed) if target == "copy" else (accepted < proposed)


@pytest.mark.parametrize("drafter", ["model", "ngram"])
def test_model_free_drafter_doubles_the_pool(drafter):
    """``num_kv_blocks`` budgets a mirrored target + draft pair; the
    n-gram drafter holds no draft KV, so its target pool doubles, and
    the one-max-length-sequence check is made on the doubled pool."""
    tcfg = t_get_config("smollm-135m").reduced()
    spec = TSpec(drafter=drafter)
    mirror = drafter == "model"
    kw = dict(max_batch_size=2, max_seq_len=128, kv_block_size=16,
              num_kv_blocks=8, paged_kv=True)
    sched = LookaheadScheduler(TServing(**kw), spec,
                               kv_mirror=t_build_drafter(spec, tcfg).mirrors_kv(),
                               block_bytes=100)
    assert sched.kv_blocks_total() == (8 if mirror else 16)
    assert sched.kv_bytes_total() == 100 * sched.kv_blocks_total()
    assert sched.kv_bytes_in_use() == 0
    ref_sched = RefScheduler(ServingConfig(**kw),
                             SpecDecodeConfig(drafter=drafter),
                             kv_mirror=mirror, block_bytes=100)
    assert sched.kv_blocks_total() == ref_sched.kv_blocks_total()
    assert sched.kv_bytes_total() == ref_sched.kv_bytes_total()
    # 4 blocks of 16 < 128 tokens: a mirrored pair cannot hold one
    # max-length sequence; the doubled model-free pool of 8 can
    small = TServing(**dict(kw, num_kv_blocks=4))
    if mirror:
        with pytest.raises(ValueError, match="max-length"):
            LookaheadScheduler(small, spec, kv_mirror=True)
    else:
        assert LookaheadScheduler(small, spec,
                                  kv_mirror=False).kv_blocks_total() == 8
