"""The port's dense options (untied head, qkv bias, qk norm, KV- and
query-head padding) and its MoE family against the reference, at f32 on
the CPU: configs, parameter counts, the MoE block (its overflow quirk
included), prefill and decode logits on the ring and both pools, decode
== train, greedy engine streams, the MoE loss and a train step, and
checkpoints of the new leaves."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.config import MoEConfig, OptimizerConfig, ServingConfig
from repro.core.config import SpecDecodeConfig
from repro.core.drafters.base import model_flops_per_token as ref_flops
from repro.models import cache as ref_cache
from repro.models import moe as ref_moe
from repro.models.module import count_params as ref_count
from repro.models.module import init_params as ref_init
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.request import Request
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro.training import train as ref_train
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_archs
from repro_torch.core.config import MoEConfig as TMoEConfig
from repro_torch.core.config import OptimizerConfig as TOptimizerConfig
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.core.drafters.base import model_flops_per_token
from repro_torch.launch import train as t_launch
from repro_torch.models import cache as t_cache
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_transformer
from repro_torch.models.transformer import forward
from repro_torch.models.weights import (count_params, from_reference,
                                        init_params, param_leaves,
                                        param_shapes)
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from repro_torch.training import checkpoint as t_ckpt
from repro_torch.training import data as t_data
from repro_torch.training import optimizer as t_opt
from repro_torch.training import train as t_train
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")
ATOL = 1e-4
BS, NB, MAXLEN = 8, 24, 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conv(tree):
    return from_reference(_np(tree), device="cpu")


# --------------------------------------------------------------------------
# configs and parameter counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_configs_equal_reference(arch):
    """The registered config, its reduced variant, its draft and the
    reduced draft: every field of the port's equal to the reference's
    (the port leaves out the families it does not run, all unset here)."""
    ref, port = get_config(arch), t_get_config(arch)
    for r, t in ((ref, port), (ref.reduced(), port.reduced()),
                 (ref.draft(), port.draft()),
                 (ref.reduced().draft(), port.reduced().draft())):
        rd, td = dataclasses.asdict(r), dataclasses.asdict(t)
        for key, val in rd.items():
            if key in td:
                assert td[key] == val, (arch, key)
            else:
                assert val in (None, False, 0), (arch, key, val)
    # an MoE target's draft is dense; the others keep their family
    assert port.draft().moe is None and port.draft().family == (
        "dense" if port.family == "moe" else port.family)


@pytest.mark.parametrize("arch", list_archs())
def test_full_config_param_counts_equal_reference(arch):
    """From shapes alone, at full width: the same leaves, shapes and
    count as the reference's ``model_specs``."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    specs = model_specs(cfg)
    assert count_params(tcfg) == ref_count(specs)
    # a hybrid stack's tail is a tuple: its path entries are indices
    ref_shapes = {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path): tuple(s.shape) for path, s in
                  jax.tree_util.tree_leaves_with_path(
                      specs, is_leaf=lambda x: hasattr(x, "shape"))}
    port_shapes = {k: leaf[0] for k, leaf in param_leaves(param_shapes(tcfg))}
    assert port_shapes == ref_shapes
    assert model_flops_per_token(tcfg) == ref_flops(cfg)


# --------------------------------------------------------------------------
# the MoE block
# --------------------------------------------------------------------------

def _moe_case(name):
    """(params, x, (E, k, Fe)) of a small MoE block.  ``overflow``: the
    router favours experts 1 and 3, which overflow their capacity of 24
    of 32 tokens.  ``ties``: experts 0/2 and 1/3 have the same router
    column, so every token's probabilities tie in pairs."""
    rng = np.random.RandomState(0)
    d, e, k, fe = 16, 4, 2, 8
    p = {"router": rng.randn(d, e).astype(np.float32) * 0.5,
         "w_gate": rng.randn(e, d, fe).astype(np.float32) * 0.3,
         "w_up": rng.randn(e, d, fe).astype(np.float32) * 0.3,
         "w_down": rng.randn(e, fe, d).astype(np.float32) * 0.3}
    x = rng.randn(2, 16, d).astype(np.float32)
    if name == "overflow":
        x[:, :, 0] += 2.0
        p["router"][0, 1], p["router"][0, 3] = 3.0, 2.5
    elif name == "ties":
        p["router"][:, 2] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 1]
    return p, x, (e, k, fe)


def _per_token_sum(p, x, cfg, drop_last_slot):
    """The block as a per-token sum over its kept (token, slot) pairs, in
    numpy; ``drop_last_slot`` also leaves out the pair on slot cap-1 of
    every expert that overflows (the reference's quirk)."""
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)
    n = xf.shape[0]
    logits = xf @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.top_k]
    w = np.take_along_axis(probs, idx, -1)
    w /= w.sum(-1, keepdims=True)
    cap = t_moe.capacity(n, cfg)
    counts = np.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    seen = np.zeros(cfg.num_experts, int)
    out = np.zeros_like(xf)
    for i in range(n):
        for j in range(cfg.top_k):
            ex = idx[i, j]
            slot = seen[ex]
            seen[ex] += 1
            if slot >= cap or (drop_last_slot and slot == cap - 1
                               and counts[ex] > cap):
                continue
            h = xf[i] @ p["w_gate"][ex]
            h = h / (1 + np.exp(-h)) * (xf[i] @ p["w_up"][ex])
            out[i] += w[i, j] * (h @ p["w_down"][ex])
    return out.reshape(x.shape)


@pytest.mark.parametrize("case", ["random", "overflow", "ties"])
def test_moe_apply_matches_reference(case):
    p, x, (e, k, fe) = _moe_case(case)
    rcfg, tcfg = MoEConfig(e, k, fe), TMoEConfig(e, k, fe)
    ry, raux = ref_moe.moe_apply({n: jnp.asarray(v) for n, v in p.items()},
                                 rcfg, jnp.asarray(x))
    ty, taux = t_moe.moe_apply({n: torch.from_numpy(v) for n, v in p.items()},
                               tcfg, torch.from_numpy(x))
    ry = np.asarray(ry)
    np.testing.assert_allclose(ty.numpy(), ry, atol=1e-5)
    assert sorted(taux) == sorted(raux)
    for key in raux:
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(raux[key]),
                                   atol=1e-6, err_msg=key)
    assert float(taux["dropped_fraction"]) == float(raux["dropped_fraction"])
    assert t_moe.capacity(32, tcfg) == ref_moe._capacity(32, rcfg) == 24
    quirk = _per_token_sum(p, x, tcfg, drop_last_slot=True)
    kept = _per_token_sum(p, x, tcfg, drop_last_slot=False)
    for y in (ty.numpy(), ry):
        np.testing.assert_allclose(y, quirk, atol=1e-4)
    if case == "overflow":
        # experts 1 and 3 overflow: a quarter of the pairs is dropped, and
        # in both packages slot cap-1 of each is lost as well
        assert float(raux["dropped_fraction"]) > 0
        for y in (ty.numpy(), ry):
            assert np.abs(y - kept).max() > 1.0
    else:
        assert float(raux["dropped_fraction"]) == 0
        np.testing.assert_allclose(ty.numpy(), kept, atol=1e-4)


# --------------------------------------------------------------------------
# prefill and decode logits on the ring, the fp32 pool and the int8 pool
# --------------------------------------------------------------------------

LOGIT_CASES = ("granite-moe-3b-a800m", "mixtral-8x22b", "qwen3-32b",
               "qwen2.5-32b", "granite-8b", "paper-gemma-pair",
               "kv-head-pad", "q-head-pad")
DENSE_OPTION_CASES = ("qwen3-32b", "qwen2.5-32b", "granite-8b",
                      "paper-gemma-pair", "kv-head-pad", "q-head-pad")


@functools.lru_cache(maxsize=None)
def _model(case):
    """(reference cfg, reference params, port cfg, port params) at the
    reduced width.  The zero-initialised qkv biases and qk-norm scales
    are drawn, so the options change the function.  ``kv-head-pad``:
    qwen3 (4 query heads over 1 KV head) with the KV head stored 4
    times; ``q-head-pad``: smollm with 8 query heads, the last 4 with
    zero ``wo`` rows (the reference's exactness tests)."""
    base = {"kv-head-pad": "qwen3-32b", "q-head-pad": "smollm-135m"}.get(
        case, case)
    extra = {"kv-head-pad": dict(kv_head_pad=4),
             "q-head-pad": dict(q_head_pad=8)}.get(case, {})
    cfg0 = get_config(base).reduced()
    cfg = dataclasses.replace(cfg0, **extra)
    tcfg = dataclasses.replace(t_get_config(base).reduced(), **extra)
    params = ref_init(model_specs(cfg0), jax.random.PRNGKey(1), jnp.float32)
    if case == "q-head-pad":
        a0 = params["layers"]["attn"]
        params["layers"]["attn"] = dict(
            a0, wq=jnp.concatenate([a0["wq"], jnp.zeros_like(a0["wq"])], 2),
            wo=jnp.concatenate([a0["wo"], jnp.zeros_like(a0["wo"])], 1))
    rng = np.random.RandomState(4)
    attn = params["layers"]["attn"]
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in attn:
            attn[name] = jnp.asarray(
                0.3 * rng.randn(*attn[name].shape).astype(np.float32))
    return cfg, params, tcfg, _conv(params)


def _tables(b):
    perm = np.random.RandomState(0).permutation(NB)
    per = min(NB // b, MAXLEN // BS)
    table = np.full((b, MAXLEN // BS), -1, np.int32)
    for i in range(b):
        table[i, :per] = perm[i * per:(i + 1) * per]
    return table


def _port_cache(tcfg, b, layout):
    if layout == "ring":
        return t_cache.cache_struct(tcfg, b, MAXLEN)
    tc = t_cache.paged_cache_struct(
        tcfg, b, MAXLEN, NB, BS, kv_quant="int8" if layout == "int8" else "none")
    tc["block_table"] = torch.from_numpy(_tables(b))
    return tc


def _caches(cfg, tcfg, b, layout):
    """(reference cache, port cache) of one layout, same block tables."""
    if layout == "ring":
        rc = ref_cache.cache_struct(cfg, b, MAXLEN, jnp.float32)
    else:
        rc = ref_cache.paged_cache_struct(
            cfg, b, MAXLEN, NB, BS, jnp.float32,
            kv_quant="int8" if layout == "int8" else "none")
        rc["block_table"] = jnp.asarray(_tables(b))
    return rc, _port_cache(tcfg, b, layout)


@pytest.mark.parametrize("layout", ["ring", "pool", "int8"])
@pytest.mark.parametrize("case", LOGIT_CASES)
def test_prefill_and_decode_logits_match_reference(case, layout):
    cfg, params, tcfg, tparams = _model(case)
    rng = np.random.RandomState(3)
    lens = np.array([9, 5, 13])
    toks = rng.randint(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    mask = np.arange(16)[None] < lens[:, None]
    rc, tc = _caches(cfg, tcfg, 3, layout)
    if case == "kv-head-pad":
        assert tuple(tc["k"].shape[-2:]) == tuple(rc["k"].shape[-2:]) == (4, 64)
    rl, rc, _ = ref_forward(params, cfg, jnp.asarray(toks), cache=rc,
                            mode="prefill", input_mask=jnp.asarray(mask))
    tl, tc = forward(tparams, tcfg, torch.from_numpy(toks), cache=tc,
                     mode="prefill", input_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(rl)[mask],
                               atol=ATOL)
    rc["length"] = jnp.asarray(lens, jnp.int32)
    tc["length"] = torch.from_numpy(lens.astype(np.int32))
    rows = np.arange(3)
    for t in (1, 5):                   # a draft step and a K+1 = 5 verify
        if layout == "int8":
            _same_int8_pools(rc, tc)
        nxt = rng.randint(0, cfg.vocab_size, size=(3, t)).astype(np.int32)
        keep = np.ones((3, t), bool)
        keep[1, -1] = t == 1           # a dropped write on the verify pass
        rl, rc, _ = ref_forward(params, cfg, jnp.asarray(nxt), cache=rc,
                                mode="decode", write_mask=jnp.asarray(keep))
        tl, tc = forward(tparams, tcfg, torch.from_numpy(nxt), cache=tc,
                         mode="decode", write_mask=torch.from_numpy(keep))
        if layout == "int8":
            rows = np.setdiff1d(np.arange(3), _same_int8_pools(rc, tc))
            assert len(rows) >= 2
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(rl)[rows],
                                   atol=ATOL)


def _same_int8_pools(rc, tc):
    """The port's int8 pools against the reference's: the scales within
    1e-4 relative (amax / 127 of K/V that are raw activations), the values
    equal but for a few at a rounding boundary, which K/V 1e-6 apart may
    send either way (one quantum, at most 1 in 10^4 values).  Then the
    reference's stored values go into the port's pools, so that the next
    call reads the same pool in both packages.  Returns the batch rows
    that own a value rounded the other way: their logits of this call
    read another stored value (one quantum of V moves a logit by about
    1e-4 here) and are held by this rule instead of the logit bound."""
    owner = np.full(NB, -1)
    for i, row in enumerate(_tables(3)):
        owner[row[row >= 0]] = i
    flipped = set()
    for name in ("k", "v", "k_scale", "v_scale"):
        want = np.asarray(rc[name])
        got = tc[name][:, :NB]
        if name.endswith("scale"):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
        else:
            diff = np.abs(got.numpy().astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, name
            flipped |= set(owner[np.argwhere(diff > 0)[:, 1]].tolist())
        got.copy_(torch.from_numpy(np.array(want)))
    return sorted(flipped)



@pytest.mark.parametrize("layout", ["ring", "pool"])
@pytest.mark.parametrize("case", DENSE_OPTION_CASES)
def test_decode_matches_train_forward(case, layout):
    """Prefill, then a 5-token verify, then a commit of 2 and a 4-token
    re-verify == the full-context train forward.  MoE is left out: its
    capacity counts every row of a call, so a decode is another batch
    than the train forward (the reference deselects the same cases)."""
    _, _, tcfg, tparams = _model(case)
    b, s = 2, 10
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, tcfg.vocab_size, size=(b, s + 9)).astype(np.int32))
    full, _ = forward(tparams, tcfg, toks, mode="train")
    tc = _port_cache(tcfg, b, layout)
    _, tc = forward(tparams, tcfg, toks[:, :s], cache=tc, mode="prefill")
    tc["length"] = torch.full((b,), s, dtype=torch.int32)
    got, tc = forward(tparams, tcfg, toks[:, s:s + 5], cache=tc,
                      mode="decode")
    torch.testing.assert_close(got, full[:, s:s + 5], atol=2e-3, rtol=0)
    tc = t_transformer.commit(tparams, tcfg, toks[:, s:s + 5], tc, tc,
                              torch.full((b,), 2, dtype=torch.int32))
    got, _ = forward(tparams, tcfg, toks[:, s + 2:s + 6], cache=tc,
                     mode="decode")
    torch.testing.assert_close(got, full[:, s + 2:s + 6], atol=2e-3, rtol=0)


# --------------------------------------------------------------------------
# greedy engine streams against the reference engine's
# --------------------------------------------------------------------------

def _count_dropping_calls(monkeypatch):
    """The number of the port's MoE calls that dropped a (token, slot)
    pair, counted as they run."""
    calls = []
    orig = t_transformer.moe_apply

    def counted(p, cfg, x):
        y, aux = orig(p, cfg, x)
        calls.append(float(aux["dropped_fraction"]) > 0)
        return y, aux
    monkeypatch.setattr(t_transformer, "moe_apply", counted)
    return calls


STREAMS = {
    # arch, drafter, paged, kv_quant, blocks, prompt lengths, new tokens
    "moe-pool-preempt": ("granite-moe-3b-a800m", "model", True, "none", 16,
                         (30, 25, 20), 40),
    "moe-ring": ("granite-moe-3b-a800m", "model", False, "none", None,
                 (30, 25, 20), 40),
    "moe-ngram-int8": ("granite-moe-3b-a800m", "ngram", True, "int8", 32,
                       (30, 25, 20), 40),
    "qwen3-pool": ("qwen3-32b", "model", True, "none", 16, (30, 25, 20), 40),
    # the self drafter slices the MoE leaves of the target's first layer
    "moe-self-ring": ("granite-moe-3b-a800m", "self", False, "none", None,
                      (7, 12, 5), 16),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_greedy_streams_match_reference(name, monkeypatch):
    """dsde, batch 2, blocks of 8; the model drafter is the target's own
    ``draft()`` (dense, with its own KV heads in the mirror pool).  The
    pool cases run past 16 blocks, so requests are preempted and
    recomputed.  The n-gram drafter looks up 1-grams: a random target
    repeats no longer n-gram.  The self drafter drafts with the target's
    first layer."""
    arch, drafter, paged, quant, nblocks, lens, new = STREAMS[name]
    cfg, pt, tcfg, tpt = _model(arch)
    dcfg, tdcfg = cfg.draft(), tcfg.draft()
    model = drafter == "model"
    pd = (ref_init(model_specs(dcfg), jax.random.PRNGKey(2), jnp.float32)
          if model else None)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    kw = dict(max_batch_size=2, max_seq_len=128, paged_kv=paged,
              kv_block_size=8, num_kv_blocks=nblocks, kv_quant=quant)
    spec = dict(policy="dsde", drafter=drafter, ngram_n=1)
    dropping = _count_dropping_calls(monkeypatch)
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
    assert [r.output for r in treqs] == [r.output for r in reqs]
    assert all(len(r.output) == new for r in treqs)
    for key in ("rounds", "tokens_emitted", "preemptions", "draft_steps",
                "kv_pool_blocks", "kv_block_bytes", "kv_pool_bytes"):
        assert tm[key] == m[key], key
    assert sum(r["proposed"] for r in teng.round_log) > 0
    if paged and name != "moe-ngram-int8":
        assert tm["preemptions"] >= 1
    if cfg.family == "moe":
        # some verify passes overflowed an expert: the quirk is on the path
        assert any(dropping)


def test_moe_pipelined_streams_match_reference():
    """granite's routing (40 experts, top 8) at the reduced width, batch
    4, 8 requests of 32 tokens on the fp32 pool: the port's synchronous
    and pipelined streams each equal the reference's.  The pipelined
    schedule runs other rows beside a request in some rounds (a finished
    request stays a round longer, the next starts a round later) and the
    capacity couples a call's rows, so here the reference's own
    pipelined streams part from its synchronous ones (a known deviation
    of the reference, ROADMAP C): the port parts in the same place."""
    cfg0, tcfg0 = get_config("granite-moe-3b-a800m").reduced(), t_get_config(
        "granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(cfg0, moe=MoEConfig(40, 8, 256))
    tcfg = dataclasses.replace(tcfg0, moe=TMoEConfig(40, 8, 256))
    pt = ref_init(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    pd = ref_init(model_specs(cfg.draft()), jax.random.PRNGKey(2),
                  jnp.float32)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(6, 21)).tolist()
               for _ in range(8)]
    out = {}
    for pipelined in (False, True):
        kw = dict(max_batch_size=4, max_seq_len=256, paged_kv=True,
                  kv_block_size=16, num_kv_blocks=32, pipelined=pipelined)
        teng = TEngine(_conv(pt), tcfg, _conv(pd), tcfg.draft(), TSpec(),
                       TServing(**kw), device="cpu")
        treqs = [TRequest(i, prompt=p, max_new_tokens=32)
                 for i, p in enumerate(prompts)]
        teng.run(treqs)
        eng = ServingEngine(pt, cfg, pd, cfg.draft(), SpecDecodeConfig(),
                            ServingConfig(**kw))
        reqs = [Request(i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        out[pipelined] = ([r.output for r in treqs], [r.output for r in reqs])
        assert out[pipelined][0] == out[pipelined][1], pipelined
    assert out[False][1] != out[True][1]


# --------------------------------------------------------------------------
# training: the MoE loss, a train step, checkpoints, the launcher
# --------------------------------------------------------------------------

STEP_OPT = dict(learning_rate=1e-5, warmup_steps=2, total_steps=10)


def make_reference_step(cfg):
    return jax.jit(functools.partial(
        ref_train.train_step, cfg=cfg, opt_cfg=OptimizerConfig(**STEP_OPT),
        remat=True))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_loss_and_train_step_match_reference(arch):
    """loss_fn's loss and metrics within 1e-5 (the router's aux losses
    included), then one train step's params within 1e-4 at lr 1e-5."""
    cfg, params, tcfg, tparams = _model(arch)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    labs = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    rloss, rm = ref_train.loss_fn(params, cfg, jnp.asarray(toks),
                                  jnp.asarray(labs))
    tloss, tm = t_train.loss_fn(tparams, tcfg, torch.from_numpy(toks),
                                torch.from_numpy(labs))
    assert sorted(tm) == sorted(rm)
    assert float(rm["load_balance"]) > 0 and float(rm["router_z"]) > 0
    for key in rm:
        assert abs(float(tm[key]) - float(rm[key])) <= 1e-5 * max(
            1.0, abs(float(rm[key]))), key
    step = make_reference_step(cfg)
    rp, _, rm = step(params, ref_opt.init_adamw(params), jnp.asarray(toks),
                     jnp.asarray(labs))
    tp, _, tm = t_train.train_step(
        tparams, t_opt.init_adamw(tparams), torch.from_numpy(toks),
        torch.from_numpy(labs), cfg=tcfg,
        opt_cfg=TOptimizerConfig(**STEP_OPT), remat=True)
    for key in ("loss", "ce_loss"):
        assert abs(float(tm[key]) - float(rm[key])) <= 1e-4 * abs(
            float(rm[key])), key
    # the grad norm sums squares over every leaf of a saturated init and
    # moves more than the params do (chip_smoke.py's train check: 2e-3)
    assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= 2e-3 * abs(
        float(rm["grad_norm"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(rp):
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.numpy(), np.asarray(leaf), atol=1e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2.5-32b"])
def test_new_leaves_checkpoint_both_ways(arch, tmp_path):
    """The MoE leaves, the untied head and the biases / norms round-trip
    through either package's checkpoint files."""
    cfg, params, tcfg, _ = _model(arch)
    tp = init_params(tcfg, seed=3, device="cpu")
    fname = t_ckpt.save_checkpoint(str(tmp_path / "port"), 1, tp)
    restored, _ = ref_ckpt.restore_checkpoint(fname, params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(restored):
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 2, params)
    got, _ = t_ckpt.restore_checkpoint(
        t_ckpt.latest_checkpoint(str(tmp_path / "ref")), tp)
    assert [k for k, _ in param_leaves(got)] == [k for k, _ in param_leaves(tp)]
    for key, leaf in param_leaves(got):
        t = params
        for k in key:
            t = t[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(t))


class _ShortStreamCorpus(t_data.MarkovTaskCorpus):
    def stream(self, total, seed=0):
        return super().stream(min(total, 4000), seed)


def test_demo_launcher_trains_an_moe_arch(tmp_path, monkeypatch):
    monkeypatch.setattr(t_launch, "MarkovTaskCorpus", _ShortStreamCorpus)
    out = t_launch.main(["--arch", "granite-moe-3b-a800m", "--demo",
                         "--steps", "2", "--ckpt-dir", str(tmp_path),
                         "--device", "cpu"])
    assert out["steps"] == 2 and np.isfinite(out["loss"])
    assert out["loss"] > out["ce_loss"]          # the aux losses count
    # a recurrent arch's demo trains now (tests/test_torch_training.py);
    # without --demo the launcher dry-runs its train_4k step
    rec = t_launch.main(["--arch", "mamba2-130m", "--reduced"])
    assert rec["status"] == "ok" and rec["shape"] == "train_4k"
