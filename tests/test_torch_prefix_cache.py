"""The port's prefix cache (DESIGN.md §12) against the reference's: the
refcounted, hash-chained block allocator on the same operation traces,
warm admission (coverage, copy-on-write, pinning, preemption), the
copy-on-write block copies, and warm greedy streams equal to the
reference's warm streams and to the port's own cold streams, on the
fp32 and int8 pools, under preemption and eviction, on both
schedules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # offline container: deterministic fallback
    from _hypothesis_shim import given, settings, strategies as st

from repro.configs import get_config
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.models import cache as ref_cache
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.request import Request
from repro.serving.scheduler import BlockAllocator, LookaheadScheduler
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import prefill as t_prefill
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.models import cache as t_cache
from repro_torch.models.weights import from_reference
from repro_torch.models.weights import init_params as init_params_port
from repro_torch.serving import engine as t_engine_mod
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.request import RequestState
from repro_torch.serving.scheduler import BlockAllocator as TAllocator
from repro_torch.serving.scheduler import LookaheadScheduler as TScheduler
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")


# ---------------------------------------------------------------------------
# BlockAllocator units (the reference's cases, on the port's allocator)
# ---------------------------------------------------------------------------

def _register_chain(a, blocks, tokens):
    h = None
    bs = a.block_size
    for i, b in enumerate(blocks):
        h = a.register(b, h, tuple(tokens[i * bs:(i + 1) * bs]))
    return h


def test_refcount_shared_blocks_survive_one_owner_freeing():
    a = TAllocator(num_blocks=8, block_size=4)
    blocks = a.alloc(2)
    _register_chain(a, blocks, list(range(8)))
    a.acquire(blocks)
    a.free(blocks)
    assert all(a.refcount[b] == 1 for b in blocks) and a.n_cached == 0
    a.free(blocks)
    assert a.n_cached == 2                 # registered: warm, not free
    ids, _, covered = a.match_prefix(list(range(8)))
    assert ids == blocks and covered == 8
    a.acquire(ids)                         # revived in place
    assert a.n_cached == 0 and all(a.refcount[b] == 1 for b in ids)


def test_unregistered_blocks_free_immediately():
    a = TAllocator(num_blocks=4, block_size=4)
    a.free(a.alloc(3))
    assert a.n_cached == 0 and a.n_free == 4


def test_match_prefix_walks_full_blocks_only():
    a = TAllocator(num_blocks=8, block_size=4)
    blocks = a.alloc(3)
    _register_chain(a, blocks[:2], list(range(8)))
    a.free(blocks)
    assert a.match_prefix(list(range(11)))[::2] == (blocks[:2], 8)
    assert a.match_prefix(list(range(6)))[::2] == (blocks[:1], 4)
    assert a.match_prefix([99] + list(range(1, 8)))[::2] == ([], 0)


def test_match_verifies_stored_tokens_not_just_hashes():
    a = TAllocator(num_blocks=4, block_size=2)
    blocks = a.alloc(1)
    a.register(blocks[0], None, (1, 2))
    a.free(blocks)
    a._index[TAllocator._chain_hash(None, (3, 4))] = blocks[0]
    assert a.match_prefix([3, 4])[::2] == ([], 0)
    assert a.match_prefix([1, 2])[0] == blocks


def test_lru_eviction_only_under_pressure_oldest_first():
    a = TAllocator(num_blocks=4, block_size=2)
    b1 = a.alloc(1)
    _register_chain(a, b1, [1, 2])
    a.free(b1)
    b2 = a.alloc(1)
    _register_chain(a, b2, [3, 4])
    a.free(b2)
    got = a.alloc(2)
    assert a.evictions == 0 and a.n_cached == 2
    got2 = a.alloc(1)
    assert a.evictions == 1
    assert a.match_prefix([1, 2])[0] == [] and a.match_prefix([3, 4])[0] == b2
    assert a.alloc(2) is None
    a.free(got + got2)
    a.check_invariants()


def test_registration_is_first_writer_wins():
    a = TAllocator(num_blocks=4, block_size=2)
    b1, b2 = a.alloc(1), a.alloc(1)
    assert a.register(b1[0], None, (5, 6)) == a.register(b2[0], None, (5, 6))
    assert a.match_prefix([5, 6])[0] == b1
    a.free(b1)
    a.free(b2)
    assert a.n_cached == 1
    a.check_invariants()


def test_fork_cow_allocates_then_releases_source():
    a = TAllocator(num_blocks=3, block_size=2)
    src = a.alloc(1)
    _register_chain(a, src, [7, 8])
    a.acquire(src)
    dst = a.fork_cow(src[0])
    assert dst is not None and dst != src[0]
    assert a.refcount[src[0]] == 1 and a.refcount[dst] == 1
    a.free(src)
    assert a.n_cached == 1 and a.match_prefix([7, 8])[0] == src
    a.check_invariants()


def _snapshot(a):
    return (list(a.refcount), a.n_free, a.n_used, a.n_cached, a.evictions,
            sorted(a._index.values()))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(0, 2 ** 31 - 1), min_size=4, max_size=80),
       st.integers(4, 12))
def test_allocator_op_trace_matches_reference(ops, num_blocks):
    """One random trace of alloc, free, register, acquire and COW forks
    fed to both allocators: the same ids, refcounts, warm counts and
    index after every op, and both keep their invariants."""
    ref, port = BlockAllocator(num_blocks, 2), TAllocator(num_blocks, 2)
    owned = []                             # [(blocks, registered_upto)]
    token = 0
    for x in ops:
        op = x % 5
        if op == 0:
            n = (x // 5) % (num_blocks + 1)
            got = ref.alloc(n)
            assert port.alloc(n) == got
            if got:
                owned.append([got, 0])
        elif op == 1 and owned:
            blocks, _ = owned.pop((x // 5) % len(owned))
            ref.free(blocks)
            port.free(blocks)
        elif op == 2 and owned:
            ent = owned[(x // 5) % len(owned)]
            if ent[1] < len(ent[0]):
                b = ent[0][ent[1]]
                parent = ref._meta[ent[0][ent[1] - 1]][2] if ent[1] else None
                chunk = (token, token + 1)
                assert ref.register(b, parent, chunk) == port.register(
                    b, parent, chunk)
                token += 2
                ent[1] += 1
        elif op == 3 and owned:
            blocks = owned[(x // 5) % len(owned)][0]
            ref.acquire(blocks)
            port.acquire(blocks)
            owned.append([list(blocks), 0])
        elif op == 4 and owned:
            ent = owned[(x // 5) % len(owned)]
            j = (x // 7) % len(ent[0])
            dst = ref.fork_cow(ent[0][j])
            assert port.fork_cow(ent[0][j]) == dst
            if dst is not None:
                ent[0][j] = dst
                ent[1] = min(ent[1], j)
        ref.check_invariants()
        port.check_invariants()
        assert _snapshot(port) == _snapshot(ref)
    for blocks, _ in owned:
        ref.free(blocks)
        port.free(blocks)
    port.check_invariants()
    assert port.n_free == num_blocks and _snapshot(port) == _snapshot(ref)


# ---------------------------------------------------------------------------
# Warm admission, both schedulers on the same operations
# ---------------------------------------------------------------------------

def _scheds(slots=1, max_seq=128, bs=16, nblocks=None):
    kw = dict(max_batch_size=slots, max_seq_len=max_seq, paged_kv=True,
              kv_block_size=bs, num_kv_blocks=nblocks, prefix_caching=True)
    return (LookaheadScheduler(ServingConfig(**kw),
                               SpecDecodeConfig(policy="static", static_sl=2)),
            TScheduler(TServing(**kw), TSpec(policy="static", static_sl=2)))


def _both(scheds, prompt, rid, max_new=16):
    out = []
    for s, cls in zip(scheds, (Request, TRequest)):
        r = cls(rid, prompt=list(prompt), max_new_tokens=max_new)
        s.submit(r)
        out.append(r)
    return out


def _admit(scheds):
    got = [[r.request_id for r in s.admit()] for s in scheds]
    assert got[0] == got[1]
    return got[1]


def _prime(scheds, prompt):
    """Admit, commit and release one request in both schedulers, so its
    prompt's full blocks are registered and warm."""
    reqs = _both(scheds, prompt, 10_000 + scheds[1]._admit_seq, max_new=1)
    _admit(scheds)
    for s, r in zip(scheds, reqs):
        r.cache_len = len(prompt)
        s.register_prefix(r)
        s.release(r)


def _same(ref_reqs, port_reqs, scheds):
    for r, t in zip(ref_reqs, port_reqs):
        assert (r.state.value, r.block_ids, r.prefill_start, r.fresh_block_ids,
                r.cow_pairs, r.hashed_blocks, r.chain_hash) == (
            t.state.value, t.block_ids, t.prefill_start, t.fresh_block_ids,
            t.cow_pairs, t.hashed_blocks, t.chain_hash)
    ref, port = scheds
    assert _snapshot(port.allocator) == _snapshot(ref.allocator)
    assert (port.prefix_hit_blocks_total, port.cow_copies_total,
            port.prefix_tokens_total, port.prefix_hit_tokens_total) == (
        ref.prefix_hit_blocks_total, ref.cow_copies_total,
        ref.prefix_tokens_total, ref.prefix_hit_tokens_total)
    port.allocator.check_invariants()


def test_admission_fits_only_because_of_cache_coverage():
    """pool 7 x 16 < prompt + max_new + lookahead (8 blocks): a cold pool
    rejects; with 6 prompt blocks cached the residual ask is 2 blocks and
    the request admits, as in the reference."""
    prompt = list(range(97))
    cold = _scheds(nblocks=7)
    reqs = _both(cold, prompt, 0)
    assert _admit(cold) == []
    assert reqs[1].state == RequestState.REJECTED
    warm = _scheds(nblocks=7)
    _prime(warm, prompt)
    reqs = _both(warm, prompt, 1)
    assert _admit(warm) == [1]
    assert reqs[1].prefill_start == 96 and len(reqs[1].fresh_block_ids) == 1
    _same([reqs[0]], [reqs[1]], warm)


def test_full_aligned_hit_plans_exactly_one_cow_pair():
    prompt = list(range(32))
    s = _scheds(nblocks=16)
    _prime(s, prompt)
    ref_r, port_r = _both(s, prompt, 1, max_new=8)
    assert _admit(s) == [1]
    assert port_r.prefill_start == 31 and len(port_r.cow_pairs) == 1
    src, dst = port_r.cow_pairs[0]
    assert dst in port_r.fresh_block_ids and src not in port_r.block_ids
    assert s[1].allocator.refcount[src] == 1     # pinned until enqueued
    _same([ref_r], [port_r], s)
    for sch, r in zip(s, (ref_r, port_r)):
        sch.release_cow_sources(r)
    assert s[1].allocator.n_cached == 1
    _same([ref_r], [port_r], s)


def test_admission_pins_matched_blocks_before_allocating():
    """The match must be pinned before ``alloc`` evicts under pressure:
    the LRU-oldest warm blocks are exactly the matched ones, and the
    eviction must land on the other chain."""
    s = _scheds(nblocks=8)
    chain_a, chain_b = list(range(64)), list(range(500, 532))
    _prime(s, chain_a)
    _prime(s, chain_b)
    ref_r, port_r = _both(s, chain_a + list(range(100, 133)), 1)
    assert _admit(s) == [1]
    assert port_r.prefill_start == 64 and s[1].allocator.evictions == 1
    assert s[1].allocator.match_prefix(chain_a)[2] == 64
    _same([ref_r], [port_r], s)


def test_preempted_request_recovers_coverage_on_readmit():
    prompt = list(range(40))
    s = _scheds(slots=2, nblocks=16)
    _prime(s, prompt)
    ref_r, port_r = _both(s, prompt, 1, max_new=8)
    assert _admit(s) == [1]
    assert port_r.prefill_start == 32
    for sch, r in zip(s, (ref_r, port_r)):
        sch.preempt(r)
    assert (port_r.prefill_start, port_r.cow_pairs, port_r.hashed_blocks,
            port_r.chain_hash) == (0, [], 0, None)
    _same([ref_r], [port_r], s)
    assert _admit(s) == [1]
    assert port_r.prefill_start == 32
    _same([ref_r], [port_r], s)


def test_small_pool_allowed_only_with_prefix_caching():
    kw = dict(max_batch_size=2, max_seq_len=256, paged_kv=True,
              kv_block_size=16, num_kv_blocks=8)
    with pytest.raises(ValueError, match="max-length"):
        TScheduler(TServing(**kw), TSpec())
    s = TScheduler(TServing(prefix_caching=True, **kw), TSpec())
    assert s.prefix_cache and s.kv_blocks_cached() == 0


# ---------------------------------------------------------------------------
# copy_blocks / copy_scales
# ---------------------------------------------------------------------------

def test_copy_blocks_and_scales_match_reference_at_the_sentinel():
    """Pairs padded with the sentinel ``num_blocks``: the reference drops
    those writes, the port copies its drop block onto itself; every
    allocatable block ends equal, K, V, kv_pos and both scale pools."""
    n, bs, L, kv, d = 6, 4, 2, 3, 8
    rng = np.random.RandomState(0)
    k = rng.randn(L, n, bs, kv, d).astype(np.float32)
    v = rng.randn(L, n, bs, kv, d).astype(np.float32)
    pos = rng.randint(-1, 50, size=(n, bs)).astype(np.int32)
    ks = rng.rand(L, n, bs, kv).astype(np.float32)
    vs = rng.rand(L, n, bs, kv).astype(np.float32)
    src, dst = np.array([2, n, 0, n]), np.array([4, n, 5, n])
    rk, rv, rp = ref_cache.copy_blocks(jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pos), src, dst)
    rks, rvs = ref_cache.copy_scales(jnp.asarray(ks), jnp.asarray(vs),
                                     src, dst)

    def with_drop(a, axis):        # the port's pools carry block n
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, 1)
        return torch.from_numpy(np.pad(a, pad, constant_values=7))

    tk, tv, tp = with_drop(k, 1), with_drop(v, 1), with_drop(pos, 0)
    tks, tvs = with_drop(ks, 1), with_drop(vs, 1)
    drop = (tk[:, n].clone(), tp[n].clone(), tks[:, n].clone())
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    t_cache.copy_blocks(tk, tv, tp, s_t, d_t)
    t_cache.copy_scales(tks, tvs, s_t, d_t)
    for got, want in ((tk[:, :n], rk), (tv[:, :n], rv), (tp[:n], rp),
                      (tks[:, :n], rks), (tvs[:, :n], rvs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tk[:, n], drop[0]) and torch.equal(tp[n], drop[1])
    assert torch.equal(tks[:, n], drop[2])
    assert torch.equal(tk[:, 4], torch.from_numpy(k[:, 2]))


# ---------------------------------------------------------------------------
# Engine streams
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


# tokens below the reduced vocabulary (512): the reference clamps
# out-of-range ids, the port does not take them
RNG = np.random.RandomState(11)
SHARED = RNG.randint(0, 500, size=40).tolist()
# batch 1 seeds the cache; batch 2 hits it: a partial-hit continuation, a
# full block-aligned repeat (the COW path) and a cold outlier
BATCH1 = [SHARED + RNG.randint(0, 500, size=6).tolist()]
BATCH2 = [SHARED + RNG.randint(0, 500, size=5).tolist(),
          SHARED[:32],
          RNG.randint(0, 500, size=9).tolist()]
PREEMPT = [SHARED[:24] + RNG.randint(0, 500, size=n).tolist()
           for n in (6, 3, 1)]
EVICT_B = RNG.randint(0, 500, size=97).tolist()      # 7 blocks: drains pool
EVICT = ([list(SHARED[:32])], [list(EVICT_B)], [list(SHARED[:32])])


def _serve(pair, *, reference=False, policy="dsde", drafter="model",
           caching=True, pipelined=False, kv_quant="none", max_new=10,
           nblocks=None, bs=16, batch=2, batches=(BATCH1, BATCH2)):
    cfg, pt, pd, tcfg, tpt, tpd = pair
    kw = dict(max_batch_size=batch, max_seq_len=128, paged_kv=True,
              kv_block_size=bs, num_kv_blocks=nblocks,
              prefix_caching=caching, pipelined=pipelined, kv_quant=kv_quant)
    model = drafter == "model"
    if reference:
        eng = ServingEngine(pt, cfg, pd if model else None,
                            cfg if model else None,
                            SpecDecodeConfig(policy=policy, drafter=drafter,
                                             temperature=0.0),
                            ServingConfig(**kw), seed=0)
        req = Request
    else:
        eng = TEngine(tpt, tcfg, tpd if model else None,
                      tcfg if model else None,
                      TSpec(policy=policy, drafter=drafter),
                      TServing(**kw), seed=0, device="cpu")
        req = TRequest
    outs, reqs_all = [], []
    for j, prompts in enumerate(batches):
        reqs = [req(j * 100 + i, prompt=list(p), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        m = eng.run(reqs)
        outs += [r.output for r in reqs]
        reqs_all += reqs
    return outs, m, eng, reqs_all


PREFIX_KEYS = ("prefix_cache_hit_blocks", "prefix_cache_hit_rate",
               "cow_copies", "prefix_cache_evictions", "preemptions",
               "requests_finished", "tokens_emitted", "rounds")
LOG_KEYS = ("kv_blocks_cached", "prefix_cache_hit_blocks", "cow_copies",
            "prefix_cache_hit_rate", "kv_blocks_in_use")


def _assert_like_reference(port, ref):
    (tout, tm, teng, treqs), (out, m, eng, reqs) = port, ref
    assert tout == out
    for key in PREFIX_KEYS:
        assert tm[key] == m[key], (key, tm[key], m[key])
    assert [[r[k] for k in LOG_KEYS] for r in teng.round_log] == [
        [r[k] for k in LOG_KEYS] for r in eng.round_log]
    assert [r.prefix_hit_rate() for r in treqs] == [
        r.prefix_hit_rate() for r in reqs]
    teng.scheduler.allocator.check_invariants()


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("drafter", ["model", "ngram", "self"])
@pytest.mark.parametrize("policy", ["dsde", "static"])
def test_warm_streams_match_reference(small_pair, policy, drafter, pipelined):
    """The reference's warm-cache batches (a continuation, a full aligned
    repeat, a cold outlier): the port's warm streams, prefix summary
    fields and per-round prefix log equal the reference's, and really
    shared."""
    kw = dict(policy=policy, drafter=drafter, pipelined=pipelined)
    port = _serve(small_pair, **kw)
    _assert_like_reference(port, _serve(small_pair, reference=True, **kw))
    m, reqs = port[1], port[3]
    assert m["prefix_cache_hit_blocks"] > 0 and m["cow_copies"] >= 1
    assert reqs[1].prefix_hit_rate() > 0.0 and reqs[3].prefix_hit_rate() == 0.0


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
def test_warm_equals_cold_under_forced_preemption(small_pair, pipelined):
    kw = dict(max_new=40, bs=8, nblocks=16, batches=(PREEMPT,),
              pipelined=pipelined)
    cold = _serve(small_pair, caching=False, **kw)
    warm = _serve(small_pair, **kw)
    assert warm[1]["preemptions"] >= 1
    assert warm[1]["requests_finished"] == 3
    assert warm[0] == cold[0]
    ref = _serve(small_pair, reference=True, **kw)
    if pipelined:
        assert warm[0] == ref[0]
    else:
        _assert_like_reference(warm, ref)


def test_warm_equals_cold_under_forced_eviction(small_pair):
    kw = dict(max_new=8, nblocks=8, batch=1, batches=EVICT)
    cold = _serve(small_pair, caching=False, **kw)
    warm = _serve(small_pair, **kw)
    assert warm[1]["prefix_cache_evictions"] >= 1
    assert warm[0] == cold[0]
    _assert_like_reference(warm, _serve(small_pair, reference=True, **kw))


@pytest.mark.parametrize("drafter", ["model", "ngram"])
def test_int8_warm_equals_cold_and_reference(small_pair, drafter):
    """Inside the int8 plane: warm == cold (the aligned repeat forks a
    block, so the scales must copy with it), and, with the model
    drafter, == the reference's warm int8 streams."""
    kw = dict(policy="static", drafter=drafter, kv_quant="int8")
    cold = _serve(small_pair, caching=False, **kw)
    warm = _serve(small_pair, **kw)
    assert warm[0] == cold[0]
    assert warm[1]["cow_copies"] >= 1
    if drafter == "model":
        _assert_like_reference(warm, _serve(small_pair, reference=True, **kw))


def test_int8_warm_revival_after_eviction(small_pair):
    kw = dict(policy="static", kv_quant="int8", max_new=8, nblocks=8,
              batch=1, batches=EVICT)
    cold = _serve(small_pair, caching=False, **kw)
    warm = _serve(small_pair, **kw)
    assert warm[1]["prefix_cache_evictions"] >= 1
    assert warm[0] == cold[0]


def test_warm_admission_prefills_only_the_tail(small_pair, monkeypatch):
    """A cache-hit admission runs the tail program over a bucket sized
    by the uncached suffix (<= 16 here, where the full prompts take 64),
    for the target and the mirrored draft."""
    calls = []
    orig = t_prefill.prefill_paged_tail

    def spy(params, cfg, pk, pv, kp, rows, tokens, starts, tails, *a):
        calls.append((tokens.shape[1], (tails + starts).tolist(),
                      tails.tolist()))
        return orig(params, cfg, pk, pv, kp, rows, tokens, starts, tails, *a)

    monkeypatch.setattr(t_prefill, "prefill_paged_tail", spy)
    _serve(small_pair)
    assert len(calls) == 2                       # target + draft mirror
    for width, total, tails in calls:
        assert width <= 16
        # the continuation computes its 13 uncached tokens (2 of its 45
        # are in cached blocks' worth: 32), the aligned repeat only its last
        assert sorted(tails) == [1, 13] and sorted(total) == [32, 45]


def test_prefix_caching_gated_like_reference(small_pair):
    """Off on the dense ring; off for a family with recurrent state (the
    reference's gate, on a real hybrid stack: recurrentgemma-2b reduced
    at 5 layers, with its hybrid draft mirroring the pool); on
    otherwise."""
    _, _, _, tcfg, tpt, tpd = small_pair

    def engine():
        return TEngine(tpt, tcfg, tpd, tcfg, TSpec(), TServing(
            max_batch_size=2, max_seq_len=128, paged_kv=paged,
            prefix_caching=True), device="cpu")

    paged = False
    eng = engine()
    assert not eng.prefix_caching and not eng.scheduler.prefix_cache
    r = TRequest(0, prompt=list(range(3, 11)), max_new_tokens=4)
    m = eng.run([r])
    assert m["requests_finished"] == 1 and m["prefix_cache_hit_blocks"] == 0
    paged = True
    assert engine().prefix_caching
    assert not t_engine_mod.has_recurrent_state(tcfg)
    hcfg = dataclasses.replace(t_get_config("recurrentgemma-2b").reduced(),
                               num_layers=5)
    assert t_engine_mod.has_recurrent_state(hcfg)
    hp = init_params_port(hcfg, seed=0, device="cpu")
    eng = TEngine(hp, hcfg, hp, hcfg, TSpec(), TServing(
        max_batch_size=2, max_seq_len=128, paged_kv=True,
        prefix_caching=True), device="cpu")
    assert not eng.prefix_caching and not eng.scheduler.prefix_cache
