"""The port's recurrent families against the reference, at f32 on the
CPU: the SSD forms (chunked == recurrent, ``h0`` continuation, masked
identities) and the RG-LRU scans, the models' logits in the three modes
(mamba2-130m reduced, recurrentgemma-2b reduced and at 5 layers, on the
ring and the fp32 pool), decode == train with a partial commit, the
ragged prefill, the masked re-advance commit and the untouched snapshot,
greedy engine streams, the reference's refusals and the prefix-cache
gate on a real hybrid stack."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.models import cache as ref_cache
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro.models.module import init_params as ref_init
from repro.models.transformer import commit as ref_commit
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.request import Request
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.core.drafters.model import autoregressive_draft_loop
from repro_torch.core.policies import build_policy as t_build_policy
from repro_torch.models import cache as t_cache
from repro_torch.models import rglru as t_rglru
from repro_torch.models import ssm as t_ssm
from repro_torch.models.transformer import commit, forward
from repro_torch.models.weights import (from_reference, init_params,
                                        param_leaves, unflatten_params)
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")
ATOL = 1e-4
BS, NB, MAXLEN = 8, 24, 64

# name -> (arch, layers): the reduced configs, and the hybrid at 5 layers
# (the reduced hybrid's 2 layers hold no attention layer: divmod(2, 3)
# leaves no group; 5 layers give one (rec, rec, attn) group and a tail
# of two)
MODELS = {"ssm": ("mamba2-130m", None), "hybrid": ("recurrentgemma-2b", None),
          "hybrid5": ("recurrentgemma-2b", 5)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conv(tree):
    return from_reference(_np(tree), device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _model(name):
    """(ref cfg, ref params, port cfg, port params) of a case, the
    reference's init converted."""
    arch, layers = MODELS[name]
    cfg, tcfg = get_config(arch).reduced(), t_get_config(arch).reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    pt = ref_init(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    return cfg, pt, tcfg, _conv(pt)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _close_state(got, want):
    """Recurrent state at fp32 rounding of its own scale: the reduced
    models' random weights drive the SSD state to ~1e4, where 1e-4 is
    below one ulp."""
    want = np.asarray(want)
    _close(got, want, atol=ATOL + 1e-5 * float(np.abs(want).max()))


# --------------------------------------------------------------------------
# the SSD forms and the RG-LRU scans
# --------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    A = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    B = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("seed,chunk,s", [(0, 4, 5), (1, 8, 33), (2, 16, 17),
                                          (3, 8, 8)])
def test_ssd_chunked_equals_recurrent_and_reference(seed, chunk, s):
    """The duality (chunked == recurrent, any chunk, unaligned lengths),
    from a random ``h0``, each form against the reference's."""
    x, dt, A, B, C = _ssd_inputs(seed, 2, s, 3, 4, 5)
    h0 = np.random.RandomState(seed + 9).randn(2, 3, 4, 5).astype(np.float32)
    y1, hf1 = t_ssm.ssd_chunked(*map(_t, (x, dt, A, B, C)), chunk, _t(h0))
    y2, hf2 = t_ssm.ssd_recurrent(*map(_t, (x, dt, A, B, C, h0)))
    ry1, rhf1 = ref_ssm.ssd_chunked(x, dt, A, B, C, chunk, jnp.asarray(h0))
    ry2, rhf2 = ref_ssm.ssd_recurrent(x, dt, A, B, C, jnp.asarray(h0))
    for got, want in ((y1, ry1), (hf1, rhf1), (y2, ry2), (hf2, rhf2)):
        _close(got, want, atol=2e-5, rtol=1e-5)
    _close(y1, y2, atol=2e-4, rtol=1e-3)
    _close(hf1, hf2, atol=2e-4, rtol=1e-3)


def test_ssd_chunked_initial_state_continuation():
    """[a|b] in two chunked calls (the second from the first's state) ==
    one call over the whole."""
    x, dt, A, B, C = map(_t, _ssd_inputs(7, 1, 24, 2, 4, 3))
    y_full, hf_full = t_ssm.ssd_chunked(x, dt, A, B, C, chunk=8)
    y1, h1 = t_ssm.ssd_chunked(x[:, :10], dt[:, :10], A, B[:, :10],
                               C[:, :10], 8)
    y2, h2 = t_ssm.ssd_chunked(x[:, 10:], dt[:, 10:], A, B[:, 10:],
                               C[:, 10:], 8, h0=h1)
    _close(torch.cat([y1, y2], 1), y_full, atol=2e-4, rtol=1e-3)
    _close(h2, hf_full, atol=2e-4, rtol=1e-3)


def test_ssd_masked_steps_are_identities():
    """Masked steps leave the state exactly as the unmasked prefix left
    it, in the recurrent form (``update_mask``) and in the chunked form
    (dt = 0), as in the reference."""
    x, dt, A, B, C = _ssd_inputs(11, 1, 8, 2, 4, 3)
    h0 = np.random.RandomState(3).randn(1, 2, 4, 3).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0, 0, 0]], np.float32)
    args = list(map(_t, (x, dt, A, B, C, h0)))
    _, hf_masked = t_ssm.ssd_recurrent(*args, update_mask=_t(mask))
    _, hf_prefix = t_ssm.ssd_recurrent(args[0][:, :3], args[1][:, :3],
                                       args[2], args[3][:, :3],
                                       args[4][:, :3], args[5])
    torch.testing.assert_close(hf_masked, hf_prefix, atol=1e-6, rtol=0)
    _, hf_chunk = t_ssm.ssd_chunked(args[0], args[1] * _t(mask)[..., None],
                                    args[2], args[3], args[4], 4, args[5])
    _close(hf_chunk, hf_prefix, atol=2e-5, rtol=1e-5)
    _, rhf = ref_ssm.ssd_recurrent(x, dt, A, B, C, jnp.asarray(h0),
                                   update_mask=jnp.asarray(mask))
    _close(hf_masked, rhf, atol=1e-6)


@pytest.fixture(scope="module")
def lru():
    cfg = get_config("recurrentgemma-2b").reduced()
    p = ref_init(ref_rglru.rglru_specs(cfg), jax.random.PRNGKey(0),
                 jnp.float32)
    return p, _conv(p), cfg


@pytest.mark.parametrize("s", [1, 6, 17, 64])
def test_rglru_scan_equals_step_scan_and_reference(lru, s):
    """The log-depth scan == the step recurrence == the reference's
    associative and step scans, from a random ``h0``, with and without a
    mask whose masked steps are identities."""
    p, tp, cfg = lru
    w = cfg.rglru.lru_width
    rng = np.random.RandomState(s)
    x = (rng.randn(2, s, w) * 0.5).astype(np.float32)
    h0 = (rng.randn(2, w) * 0.1).astype(np.float32)
    mask = (rng.rand(2, s) < 0.7).astype(np.float32)
    for m in (None, mask):
        tm = None if m is None else _t(m)
        rm = None if m is None else jnp.asarray(m)
        hs1, hf1 = t_rglru.rglru_scan(tp, _t(x), _t(h0), tm)
        hs2, hf2 = t_rglru.rglru_step_scan(tp, _t(x), _t(h0), tm)
        rhs1, rhf1 = ref_rglru.rglru_scan(p, x, jnp.asarray(h0), rm)
        rhs2, _ = ref_rglru.rglru_step_scan(p, x, jnp.asarray(h0), rm)
        for got, want in ((hs1, rhs1), (hs2, rhs2), (hs1, hs2), (hf1, rhf1)):
            _close(got, want, atol=2e-5, rtol=1e-4)
        torch.testing.assert_close(hf1, hs1[:, -1].float())
    # masked tail: the final state is the unmasked prefix's
    cut = max(1, s // 2)
    mask = np.ones((1, s), np.float32)
    mask[:, cut:] = 0
    _, hf_m = t_rglru.rglru_step_scan(tp, _t(x[:1]), _t(h0[:1]), _t(mask))
    _, hf_p = t_rglru.rglru_step_scan(tp, _t(x[:1, :cut]), _t(h0[:1]))
    torch.testing.assert_close(hf_m, hf_p, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# the models: logits in three modes, decode == train, commit, snapshot
# --------------------------------------------------------------------------

def _tables(b, maxb=MAXLEN // BS):
    """Interleaved block tables over the pool: row i holds blocks i, i+b,
    ..."""
    return np.arange(b * maxb, dtype=np.int32).reshape(maxb, b).T.copy()


def _caches(cfg, tcfg, b, layout):
    """(reference cache, port cache), fresh, on the ring or the pool."""
    if layout == "ring":
        return (ref_cache.cache_struct(cfg, b, MAXLEN, jnp.float32),
                t_cache.cache_struct(tcfg, b, MAXLEN))
    rc = ref_cache.paged_cache_struct(cfg, b, MAXLEN, NB, BS, jnp.float32)
    rc["block_table"] = jnp.asarray(_tables(b))
    tc = t_cache.paged_cache_struct(tcfg, b, MAXLEN, NB, BS)
    tc["block_table"] = _t(_tables(b))
    return rc, tc


LOGIT_CASES = [("ssm", "ring"), ("hybrid", "ring"), ("hybrid5", "ring"),
               ("hybrid5", "pool")]


@pytest.mark.parametrize("name,layout", LOGIT_CASES)
def test_logits_three_modes_match_reference(name, layout):
    """Train over the whole sequence; prefill of right-padded ragged
    prompts (lengths 7 and 10: the shorter row's state must not advance
    over its padding); decode of 5 tokens from each row's length: the
    port's logits equal the reference's within 1e-4, and so do the
    caches' recurrent rows after prefill."""
    cfg, pt, tcfg, tpt = _model(name)
    b, s, t = 2, 10, 5
    lens = np.array([7, 10], np.int32)
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(b, s + t)).astype(np.int32)
    rl, _, _ = ref_forward(pt, cfg, jnp.asarray(toks), mode="train")
    tl, _ = forward(tpt, tcfg, _t(toks), mode="train")
    _close(tl, rl)
    mask = np.arange(s)[None] < lens[:, None]
    rc, tc = _caches(cfg, tcfg, b, layout)
    rl, rc, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, :s]), cache=rc,
                            mode="prefill", input_mask=jnp.asarray(mask))
    tl, tc = forward(tpt, tcfg, _t(toks[:, :s]), cache=tc, mode="prefill",
                     input_mask=_t(mask))
    _close(tl, rl)
    for key in t_cache.RECURRENT_KEYS:
        if key in tc:
            _close_state(tc[key], rc[key])
    rc["length"] = jnp.asarray(lens)
    tc["length"] = _t(lens)
    dec = toks[:, s:]
    rl, _, _ = ref_forward(pt, cfg, jnp.asarray(dec), cache=rc, mode="decode")
    tl, _ = forward(tpt, tcfg, _t(dec), cache=tc, mode="decode")
    _close(tl, rl)


@pytest.mark.parametrize("name,layout", LOGIT_CASES)
def test_decode_matches_train_forward_with_partial_commit(name, layout):
    """Incremental decode == the full-context forward, then a partial
    commit (2 of 5 tokens, the masked re-advance from the snapshot) and a
    re-verification of the rest (the reference's
    ``test_decode_matches_train_forward``); the committed state equals
    the reference commit's, and the snapshot keeps its recurrent rows
    through the verify pass and the commit."""
    cfg, pt, tcfg, tpt = _model(name)
    b, s, t = 2, 10, 5
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(b, s + t)).astype(np.int32)
    full, _ = forward(tpt, tcfg, _t(toks), mode="train")
    rc, tc = _caches(cfg, tcfg, b, layout)
    _, tc = forward(tpt, tcfg, _t(toks[:, :s]), cache=tc, mode="prefill")
    _, rc, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, :s]), cache=rc,
                           mode="prefill")
    tc["length"] = torch.full((b,), s, dtype=torch.int32)
    rc["length"] = jnp.full((b,), s, jnp.int32)
    snap = tc
    before = {k: snap[k].clone() for k in t_cache.RECURRENT_KEYS if k in snap}
    dl, tc2 = forward(tpt, tcfg, _t(toks[:, s:]), cache=tc, mode="decode")
    torch.testing.assert_close(dl, full[:, s:], atol=2e-3, rtol=1e-3)
    n2 = torch.full((b,), 2, dtype=torch.int32)
    tc3 = commit(tpt, tcfg, _t(toks[:, s:]), snap, tc2, n2)
    for key, val in before.items():
        assert torch.equal(snap[key], val), key
        assert tc3[key] is not snap[key]
    assert tc3["length"].tolist() == [s + 2, s + 2]
    _, rc2, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, s:]), cache=rc,
                            mode="decode")
    rc3 = ref_commit(pt, cfg, jnp.asarray(toks[:, s:]), rc, rc2,
                     jnp.full((b,), 2, jnp.int32))
    for key in before:
        _close_state(tc3[key], rc3[key])
    dl3, _ = forward(tpt, tcfg, _t(toks[:, s + 2:s + 4]), cache=tc3,
                     mode="decode")
    torch.testing.assert_close(dl3, full[:, s + 2:s + 4], atol=2e-3,
                               rtol=1e-3)


def test_commit_rows_take_their_own_counts_and_pool_writes_stay_put():
    """Rows committing 0, 1 and all 4 verified tokens (a dead row commits
    0) on the hybrid pool: each row's state is the one a decode of just
    its accepted tokens reaches, and the re-advance writes the pool only
    at accepted positions, with the verify pass's bits, or on the drop
    block, so the pool after commit equals the pool after verify outside
    the drop block."""
    cfg, pt, tcfg, tpt = _model("hybrid5")
    b, s, t = 3, 9, 4
    toks = _t(np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(b, s + t)).astype(np.int32))
    tc = t_cache.paged_cache_struct(tcfg, b, MAXLEN, NB, BS)
    tc["block_table"] = _t(_tables(b))
    _, tc = forward(tpt, tcfg, toks[:, :s], cache=tc, mode="prefill")
    tc["length"] = torch.full((b,), s, dtype=torch.int32)
    snap = dict(tc)
    _, tv = forward(tpt, tcfg, toks[:, s:], cache=tc, mode="decode")
    # the pools but the drop block (the last), where masked writes land
    live = {"k": lambda x: x[:, :-1], "v": lambda x: x[:, :-1],
            "kv_pos": lambda x: x[:-1]}
    pools = {k: cut(tv[k]).clone() for k, cut in live.items()}
    n = torch.tensor([0, 1, 4], dtype=torch.int32)
    tcm = commit(tpt, tcfg, toks[:, s:], snap, tv, n)
    for k, val in pools.items():
        assert torch.equal(live[k](tcm[k]), val), k
    for i in range(b):
        one = {k: (v[:, i:i + 1] if k in t_cache.RECURRENT_KEYS else v)
               for k, v in snap.items()}
        one["length"] = snap["length"][i:i + 1]
        one["block_table"] = snap["block_table"][i:i + 1]
        m = int(n[i])
        if m:
            _, one = forward(tpt, tcfg, toks[i:i + 1, s:s + m], cache=one,
                             mode="decode", write_mask=torch.zeros(
                                 (1, m), dtype=torch.bool))
        # a batch of one rounds its matmuls differently
        for key in ("lru", "conv"):
            torch.testing.assert_close(tcm[key][:, i], one[key][:, 0],
                                       atol=ATOL, rtol=0)


def test_draft_loop_leaves_the_snapshot_state():
    """The model drafter's K+1 steps over an ssm draft and a hybrid
    draft return a cache with advanced recurrent rows and leave the
    pre-round cache's untouched (its commit re-advances from them)."""
    for name in ("ssm", "hybrid5"):
        cfg, pt, tcfg, tpt = _model(name)
        b, s = 2, 6
        tc = t_cache.cache_struct(tcfg, b, MAXLEN)
        toks = _t(np.arange(b * s, dtype=np.int32).reshape(b, s) % 50)
        _, tc = forward(tpt, tcfg, toks, cache=tc, mode="prefill")
        tc["length"] = torch.full((b,), s, dtype=torch.int32)
        before = {k: tc[k].clone() for k in t_cache.RECURRENT_KEYS if k in tc}
        policy = t_build_policy(TSpec())
        _, _, drafted, _ = autoregressive_draft_loop(
            tpt, tcfg, tc, torch.zeros((b,), dtype=torch.int32), 3,
            torch.full((b,), 3, dtype=torch.int32), policy,
            lambda j: torch.full((b,), 0.5), torch.ones((b,), dtype=torch.bool),
            0.0)
        for key, val in before.items():
            assert torch.equal(tc[key], val), (name, key)
            assert not torch.equal(drafted[key], val), (name, key)


def test_hybrid_checkpoint_tree_round_trips(tmp_path):
    """The hybrid tree (stacked groups, a tuple tail; and a stack with
    no whole group: groups None) flattens in jax's leaf order, with the
    tail's indices as keys, and comes back with its tuples through a
    reference-format checkpoint that the reference restores."""
    from repro.training import checkpoint as ref_ckpt
    from repro_torch.training import checkpoint as t_ckpt
    for name in ("hybrid", "hybrid5"):
        cfg, pt, tcfg, tpt = _model(name)
        ref_paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path)
                     for path, _ in jax.tree_util.tree_leaves_with_path(pt)]
        assert ["/".join(k) for k, _ in param_leaves(tpt)] == ref_paths
        assert isinstance(tpt["layers"]["tail"], tuple)
        back = unflatten_params(param_leaves(tpt))
        assert isinstance(back["layers"]["tail"], tuple)
        fname = t_ckpt.save_checkpoint(str(tmp_path / name), 3, tpt)
        restored, _ = ref_ckpt.restore_checkpoint(fname, pt)
        for (k, a), (_, r) in zip(param_leaves(tpt), param_leaves(_np(restored))):
            np.testing.assert_array_equal(a.numpy(), r)
        tl, _ = forward(back, tcfg, torch.zeros((1, 4), dtype=torch.int32),
                        mode="train")
        assert torch.isfinite(tl).all()


def test_seeded_init_covers_both_trees():
    """``init_params`` of the recurrent configs: the reference's shapes,
    the ones-initialised leaves (``A_log``, ``D``, ``lam``) at 1."""
    for name in ("ssm", "hybrid5"):
        cfg, pt, tcfg, _ = _model(name)
        p = init_params(tcfg, seed=0, device="cpu")
        shapes = {k: tuple(v.shape) for k, v in param_leaves(p)}
        assert shapes == {k: tuple(np.shape(v))
                          for k, v in param_leaves(_np(pt))}
        for k, v in param_leaves(p):
            if k[-1] in ("A_log", "D", "lam"):
                assert bool((v == 1).all()), k


# --------------------------------------------------------------------------
# greedy engine streams against the reference engine's
# --------------------------------------------------------------------------

# a reference config whose ``source`` is this marker runs its commit
# through :func:`_masked_ref_commit` (a distinct static config, so jit
# traces of both commits coexist without clearing caches)
MASKED = "commit re-advance write-masked"


def _masked_ref_commit(params, cfg, tokens, snapshot, verified, n_committed):
    """The reference's ``commit`` with its re-advance's K/V writes kept
    to the accepted positions (the port's rule), for configs marked
    :data:`MASKED`; the reference's own otherwise.  The reference writes
    all T positions: on the hybrid pool, a slot freed by a finished
    request keeps its device table row, and its re-advance writes K/V and
    kv_pos through it into blocks given since to another request, whose
    stream then parts (ROADMAP C)."""
    if cfg.source != MASKED:
        return ref_commit(params, cfg, tokens, snapshot, verified,
                          n_committed)
    new_len = snapshot["length"] + n_committed.astype(jnp.int32)
    t = tokens.shape[1]
    acc = jnp.arange(t)[None] < n_committed[:, None]
    _, adv, _ = ref_forward(params, cfg, tokens, cache=snapshot,
                            mode="decode", update_mask=acc.astype(jnp.float32),
                            write_mask=acc)
    return ref_cache.commit_length(adv, new_len)


@pytest.fixture(scope="module", autouse=True)
def _ref_commit_switch():
    from repro.core import spec_decode as ref_sd
    from repro.core.drafters import model as ref_dm
    saved = ref_sd.commit, ref_dm.commit_model
    ref_sd.commit = ref_dm.commit_model = _masked_ref_commit
    yield
    ref_sd.commit, ref_dm.commit_model = saved


@functools.lru_cache(maxsize=None)
def _streams(name, drafter, policy, paged, pipelined, nblocks=None,
             lens=(9, 14, 6), new=16, batch=2, max_len=128, masked_ref=False):
    """(port streams, reference streams, port metrics, reference metrics)
    of one greedy serve, kept for the tests that read it again.  The model drafter is the target's own
    ``draft()`` (same family), the n-gram drafter looks up 1-grams.
    ``masked_ref``: the reference runs :func:`_masked_ref_commit`'s
    write-masked re-advance."""
    cfg, pt, tcfg, tpt = _model(name)
    if masked_ref:
        cfg = dataclasses.replace(cfg, source=MASKED)
    dcfg, tdcfg = cfg.draft(), tcfg.draft()
    model = drafter == "model"
    pd = (ref_init(model_specs(dcfg), jax.random.PRNGKey(2), jnp.float32)
          if model else None)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    kw = dict(max_batch_size=batch, max_seq_len=max_len, paged_kv=paged,
              kv_block_size=BS, num_kv_blocks=nblocks, pipelined=pipelined)
    spec = dict(policy=policy, drafter=drafter, ngram_n=1)
    teng = TEngine(tpt, tcfg, _conv(pd) if model else None,
                   tdcfg if model else None, TSpec(**spec), TServing(**kw),
                   device="cpu")
    treqs = [TRequest(i, prompt=p, max_new_tokens=new)
             for i, p in enumerate(prompts)]
    tm = teng.run(treqs)
    eng = ServingEngine(pt, cfg, pd, dcfg if model else None,
                        SpecDecodeConfig(**spec), ServingConfig(**kw))
    reqs = [Request(i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    return [r.output for r in treqs], [r.output for r in reqs], tm, m


SSM_STREAMS = [(drafter, policy, pipelined)
               for drafter in ("model", "ngram")
               for policy in ("dsde", "static", "autoregressive")
               for pipelined in (False, True)]


@pytest.mark.parametrize("drafter,policy,pipelined", SSM_STREAMS)
def test_ssm_streams_match_reference(drafter, policy, pipelined):
    """mamba2 reduced on the ring (its only layout) under each drafter
    and policy, synchronous and pipelined: the port's greedy streams and
    run counts equal the reference engine's."""
    tout, rout, tm, m = _streams("ssm", drafter, policy, False, pipelined)
    assert tout == rout
    assert all(len(o) == 16 for o in tout)
    for key in ("rounds", "tokens_emitted", "draft_steps"):
        assert tm[key] == m[key], key


def test_hybrid_ring_streams_match_reference():
    """The 5-layer hybrid with its hybrid draft under dsde on the ring,
    synchronous and pipelined: the port's greedy streams equal the
    reference engine's (the third request runs in a slot freed by the
    first)."""
    tout, rout, tm, m = _streams("hybrid5", "model", "dsde", False, False)
    assert tout == rout
    for key in ("rounds", "tokens_emitted"):
        assert tm[key] == m[key], key
    pipe, rpipe, _, _ = _streams("hybrid5", "model", "dsde", False, True)
    assert pipe == rpipe == tout


def test_hybrid_pool_streams_match_reference():
    """The same serve on the fp32 pool: the port's streams, synchronous
    and pipelined, equal the ring's and the reference's once its
    re-advance's writes are kept to the accepted positions (the
    reference as it is writes through a freed slot's table row:
    :func:`test_reference_readvance_writes_through_a_stale_table_row`,
    ROADMAP C)."""
    ring, _, _, _ = _streams("hybrid5", "model", "dsde", False, False)
    tout, rout, tm, m = _streams("hybrid5", "model", "dsde", True, False,
                                 masked_ref=True)
    assert tout == rout == ring
    assert tm["rounds"] == m["rounds"]
    pipe, rpipe, _, _ = _streams("hybrid5", "model", "dsde", True, True,
                                 masked_ref=True)
    assert pipe == rpipe == tout


def test_reference_readvance_writes_through_a_stale_table_row():
    """ROADMAP C's reference fault, one commit on the hybrid pool: row 0's
    slot was freed and keeps its table row, which now points at row 1's
    blocks; it commits 0 tokens.  The reference's re-advance writes K/V
    at row 0's positions 1-5 through it, over row 1's committed prompt
    (the engine's streams then part); the port's commit, whose
    re-advance writes only accepted positions, leaves them as the verify
    pass did."""
    cfg, pt, tcfg, tpt = _model("hybrid5")
    b, s, t = 2, 10, 5               # the decode test's shapes
    toks = np.random.RandomState(9).randint(
        0, cfg.vocab_size, size=(b, s + t)).astype(np.int32)
    rc, tc = _caches(cfg, tcfg, b, "pool")
    _, rc, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, :s]), cache=rc,
                           mode="prefill")
    _, tc = forward(tpt, tcfg, _t(toks[:, :s]), cache=tc, mode="prefill")
    stale = _tables(b)
    stale[0] = stale[1]
    lens, n = np.array([1, s], np.int32), np.array([0, t], np.int32)
    live = np.array([[False] * t, [True] * t])
    rc = dict(rc, block_table=jnp.asarray(stale), length=jnp.asarray(lens))
    tc = dict(tc, block_table=_t(stale), length=_t(lens))
    ver = toks[:, s:]
    _, rv, _ = ref_forward(pt, cfg, jnp.asarray(ver), cache=rc, mode="decode",
                           write_mask=jnp.asarray(live))
    rcm = ref_commit(pt, cfg, jnp.asarray(ver), rc, rv, jnp.asarray(n))
    _, tv = forward(tpt, tcfg, _t(ver), cache=tc, mode="decode",
                    write_mask=_t(live))
    tcm = commit(tpt, tcfg, _t(ver), tc, tv, _t(n))
    blk = int(stale[1, 0])          # row 1's first block: positions 0-7
    for key in ("k", "v"):
        assert not np.array_equal(np.asarray(rcm[key])[:, blk],
                                  np.asarray(rv[key])[:, blk]), key
        assert torch.equal(tcm[key][:, blk], tv[key][:, blk]), key


def test_hybrid_pool_preemption_streams_match_reference():
    """The fp32 pool at 8 blocks of 8 for rows of up to 64 tokens, which
    forces preemption: a readmitted request recomputes its state from
    prompt + output, and the streams equal the (write-masked)
    reference's."""
    tout, rout, tm, m = _streams("hybrid5", "model", "dsde", True, False,
                                 nblocks=8, new=24, max_len=64,
                                 masked_ref=True)
    assert tout == rout
    assert tm["preemptions"] == m["preemptions"] >= 1


# --------------------------------------------------------------------------
# the reference's refusals and the prefix-cache gate
# --------------------------------------------------------------------------

def _refusal(build):
    with pytest.raises(Exception) as info:
        build()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", ["ssm-paged", "hybrid-int8", "self-ssm"])
def test_refusals_match_reference(case):
    """ssm with the paged pool, hybrid with the int8 pool and the self
    drafter on an ssm target raise the reference's exception type with
    the reference's message."""
    name = "ssm" if case != "hybrid-int8" else "hybrid5"
    cfg, pt, tcfg, tpt = _model(name)
    if case == "self-ssm":
        ref = _refusal(lambda: ServingEngine(
            pt, cfg, None, None, SpecDecodeConfig(drafter="self"),
            ServingConfig(max_batch_size=2, max_seq_len=64)))
        port = _refusal(lambda: TEngine(
            tpt, tcfg, None, None, TSpec(drafter="self"),
            TServing(max_batch_size=2, max_seq_len=64), device="cpu"))
        assert "family" in port[1]
    else:
        kw = dict(max_batch_size=2, max_seq_len=64, paged_kv=True,
                  kv_block_size=BS,
                  kv_quant="int8" if case == "hybrid-int8" else "none")
        pd, tpd = _model(name)[1], _model(name)[3]
        ref = _refusal(lambda: ServingEngine(pt, cfg, pd, cfg,
                                             SpecDecodeConfig(),
                                             ServingConfig(**kw)))
        port = _refusal(lambda: TEngine(tpt, tcfg, tpd, tcfg, TSpec(),
                                        TServing(**kw), device="cpu"))
    assert port == ref


def test_prefix_caching_off_on_a_hybrid_stack():
    """``prefix_caching=True`` on the fp32 pool with a real hybrid target
    (and its hybrid draft) is silently off, in the engine and its
    scheduler, as in the reference; the serve runs without a hit."""
    cfg, pt, tcfg, tpt = _model("hybrid5")
    kw = dict(max_batch_size=2, max_seq_len=128, paged_kv=True,
              kv_block_size=BS, prefix_caching=True)
    eng = TEngine(tpt, tcfg, tpt, tcfg, TSpec(), TServing(**kw), device="cpu")
    ref = ServingEngine(pt, cfg, pt, cfg, SpecDecodeConfig(),
                        ServingConfig(**kw))
    assert not eng.prefix_caching and not eng.scheduler.prefix_cache
    assert eng.prefix_caching == ref.prefix_caching
    prompt = list(range(3, 27))
    m = eng.run([TRequest(i, prompt=prompt, max_new_tokens=4)
                 for i in range(2)])
    assert m["requests_finished"] == 2 and m["prefix_cache_hit_blocks"] == 0
