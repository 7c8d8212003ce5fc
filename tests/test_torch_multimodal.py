"""The port's multimodal families against the reference, at f32 on the
CPU: qwen2-vl-2b (``vlm``: M-RoPE, patch embeddings) and
seamless-m4t-medium (``audio``: the encoder-decoder), reduced.  Configs
and full-width parameter counts, M-RoPE, logits in the three modes on
the ring, the fp32 pool and the int8 pool, decode == train with a
partial commit, the encoder and the cross cache, greedy engine streams
and summaries, the encoder-conditioned round driven directly, and the
reference's own refusals and faults."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import spec_decode as ref_sd
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.core.drafters import build_drafter as ref_build_drafter
from repro.models import cache as ref_cache
from repro.models.layers import apply_rope as ref_apply_rope
from repro.models.module import count_params as ref_count
from repro.models.module import init_params as ref_init
from repro.models.transformer import build_cross_cache as ref_cross
from repro.models.transformer import commit as ref_commit
from repro.models.transformer import encode as ref_encode
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.request import Request
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import spec_decode as t_sd
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.core.drafters import build_drafter as t_build_drafter
from repro_torch.models import cache as t_cache
from repro_torch.models.layers import apply_rope, rope_angles
from repro_torch.models.transformer import (build_cross_cache, commit, encode,
                                            forward)
from repro_torch.models.weights import count_params, from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")
ATOL = 1e-4
BS, NB, MAXLEN = 8, 24, 64
ARCHS = {"vlm": "qwen2-vl-2b", "audio": "seamless-m4t-medium"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conv(tree):
    return from_reference(_np(tree), device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@functools.lru_cache(maxsize=None)
def _model(family, seed=1):
    """(ref cfg, ref params, port cfg, port params) of a reduced family,
    the reference's init converted; the zero-initialised qkv biases are
    drawn at random, so the option changes the function."""
    arch = ARCHS[family]
    cfg, tcfg = get_config(arch).reduced(), t_get_config(arch).reduced()
    pt = _np(ref_init(model_specs(cfg), jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.RandomState(seed)
    for stack in ("layers", "enc_layers"):
        for blk in pt.get(stack, {}).values():
            if isinstance(blk, dict) and "bq" in blk:
                for name in ("bq", "bk", "bv"):
                    blk[name] = (0.3 * rng.randn(*blk[name].shape)
                                 ).astype(np.float32)
    return cfg, pt, tcfg, _conv(pt)


def _embeds(seed, b, s, d):
    return (np.random.RandomState(seed).randn(b, s, d) * 0.3
            ).astype(np.float32)


def _vision_positions(b, grid, text):
    """Qwen2-VL's M-RoPE positions ``[B, T, 3]`` of a ``grid x grid``
    image then ``text`` tokens: patches at (0, h, w), text from the
    largest + 1, equal in all three streams."""
    h, w = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.zeros(grid * grid, int), h.ravel(), w.ravel()], -1)
    txt = np.repeat((img.max() + 1 + np.arange(text))[:, None], 3, 1)
    return np.broadcast_to(np.concatenate([img, txt])[None],
                           (b, grid * grid + text, 3)).astype(np.int32)


# --------------------------------------------------------------------------
# configs, parameter counts, M-RoPE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family,count", [("vlm", 1_543_910_912),
                                          ("audio", 715_454_464)])
def test_configs_and_param_counts_equal_reference(family, count):
    """Every field of the config, its ``reduced()``, ``draft()`` and
    reduced draft equal to the reference's; the full-width parameter
    count equal to the reference's ``count_params``."""
    ref, port = get_config(ARCHS[family]), t_get_config(ARCHS[family])
    for r, t in ((ref, port), (ref.reduced(), port.reduced()),
                 (ref.draft(), port.draft()),
                 (ref.reduced().draft(), port.reduced().draft())):
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert count_params(port) == ref_count(model_specs(ref)) == count


@pytest.mark.parametrize("sections,d", [((16, 24, 24), 128), ((12, 10, 10), 64),
                                        ((4, 2, 2), 16)])
def test_mrope_matches_reference(sections, d):
    """Genuinely 3-D positions (streams that differ) against the
    reference's ``apply_rope``; ``[B, T]`` positions with the sections
    set are the 1-D path bit for bit."""
    rng = np.random.RandomState(d)
    x = rng.randn(2, 7, 3, d).astype(np.float32)
    pos3 = rng.randint(0, 500, size=(2, 7, 3)).astype(np.int32)
    got = apply_rope(_t(x), rope_angles(_t(pos3), d, 1e6, sections))
    want = ref_apply_rope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    _close(got, want, atol=1e-5)
    pos = pos3[..., 0]
    one = apply_rope(_t(x), rope_angles(_t(pos), d, 1e6))
    assert torch.equal(apply_rope(_t(x), rope_angles(_t(pos), d, 1e6,
                                                      sections)), one)
    # and equal streams in [B, T, 3] are the 1-D rotation too
    _close(apply_rope(_t(x), rope_angles(_t(np.repeat(pos[..., None], 3, -1)),
                                         d, 1e6, sections)), one, atol=1e-6)


# --------------------------------------------------------------------------
# vlm logits: three modes, three layouts, embeds + 3-D positions
# --------------------------------------------------------------------------

def _tables(b, maxb=MAXLEN // BS):
    return np.arange(b * maxb, dtype=np.int32).reshape(maxb, b).T.copy()


def _caches(cfg, tcfg, b, layout):
    """(reference cache, port cache), fresh: ring, pool or int8 pool."""
    if layout == "ring":
        return (ref_cache.cache_struct(cfg, b, MAXLEN, jnp.float32),
                t_cache.cache_struct(tcfg, b, MAXLEN))
    q = "int8" if layout == "int8" else "none"
    rc = ref_cache.paged_cache_struct(cfg, b, MAXLEN, NB, BS, jnp.float32,
                                      kv_quant=q)
    rc["block_table"] = jnp.asarray(_tables(b))
    tc = t_cache.paged_cache_struct(tcfg, b, MAXLEN, NB, BS, kv_quant=q)
    tc["block_table"] = _t(_tables(b))
    return rc, tc


def _int8_sync(rc, tc, b):
    """On an int8 pool: the port's stored values against the reference's
    (scales within 1e-4 relative; values equal but for a few one quantum
    apart, where K/V 1e-6 apart sit on a rounding boundary), then the
    reference's pools copied into the port's, so the next call reads the
    same pool in both.  Returns the batch rows that own a value rounded
    the other way (their logits of this call read another stored value
    and are held by this rule instead of the logit bound); on other
    layouts, no row."""
    if "k_scale" not in tc:
        return []
    owner = np.full(NB, -1)
    for i, row in enumerate(_tables(b)):
        owner[row] = i
    flipped = set()
    for name in ("k", "v", "k_scale", "v_scale"):
        want, got = np.asarray(rc[name]), tc[name][:, :NB]
        if name.endswith("scale"):
            _close(got, want, atol=0.0, rtol=1e-4)
        else:
            diff = np.abs(got.numpy().astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
            flipped |= set(owner[np.argwhere(diff > 0)[:, 1]].tolist())
        got.copy_(torch.from_numpy(np.array(want)))
    return sorted(flipped)


def _close_rows(got, want, skip):
    rows = np.setdiff1d(np.arange(np.shape(want)[0]), skip)
    assert len(rows) >= 1
    _close(np.asarray(got)[rows], np.asarray(want)[rows])


@pytest.mark.parametrize("layout", ["ring", "pool", "int8"])
def test_vlm_logits_three_modes_match_reference(layout):
    """Train; a ragged prefill of patch ``embeds`` with M-RoPE
    ``rope_positions [B, T, 3]`` (a 3 x 3 image, then text); decode of 5
    tokens from each row's length: logits within 1e-4 of the
    reference's, and the train pass over the same embeds and positions
    too."""
    cfg, pt, tcfg, tpt = _model("vlm")
    b, grid, text, t = 2, 3, 4, 5
    s = grid * grid + text
    emb = _embeds(3, b, s, cfg.d_model)
    pos3 = _vision_positions(b, grid, text)
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(b, s + t)).astype(np.int32)
    rl, _, _ = ref_forward(pt, cfg, jnp.asarray(toks), mode="train")
    tl, _ = forward(tpt, tcfg, _t(toks), mode="train")
    _close(tl, rl)
    rl, _, _ = ref_forward(pt, cfg, None, embeds=jnp.asarray(emb),
                           rope_positions=jnp.asarray(pos3), mode="train")
    tl, _ = forward(tpt, tcfg, None, embeds=_t(emb), rope_positions=_t(pos3),
                    mode="train")
    _close(tl, rl)
    lens = np.array([s - 2, s], np.int32)
    mask = np.arange(s)[None] < lens[:, None]
    rc, tc = _caches(cfg, tcfg, b, layout)
    rl, rc, _ = ref_forward(pt, cfg, None, cache=rc, mode="prefill",
                            embeds=jnp.asarray(emb),
                            rope_positions=jnp.asarray(pos3),
                            input_mask=jnp.asarray(mask))
    tl, tc = forward(tpt, tcfg, None, cache=tc, mode="prefill",
                     embeds=_t(emb), rope_positions=_t(pos3),
                     input_mask=_t(mask))
    _close(tl, rl)
    _int8_sync(rc, tc, b)
    rc["length"] = jnp.asarray(lens)
    tc["length"] = _t(lens)
    dec = toks[:, s:]
    rl, rc, _ = ref_forward(pt, cfg, jnp.asarray(dec), cache=rc, mode="decode")
    tl, tc = forward(tpt, tcfg, _t(dec), cache=tc, mode="decode")
    _close_rows(tl, rl, _int8_sync(rc, tc, b))


@pytest.mark.parametrize("layout", ["ring", "pool", "int8"])
def test_vlm_decode_matches_train_with_partial_commit(layout):
    """Incremental decode == the full-context forward (the int8 pool:
    == the reference's decode over the same quantized pool), then a
    partial commit (2 of 5) and a re-verification of the rest."""
    cfg, pt, tcfg, tpt = _model("vlm")
    b, s, t = 2, 10, 5
    toks = np.random.RandomState(6).randint(
        0, cfg.vocab_size, size=(b, s + t)).astype(np.int32)
    full, _ = forward(tpt, tcfg, _t(toks), mode="train")
    rc, tc = _caches(cfg, tcfg, b, layout)
    _, tc = forward(tpt, tcfg, _t(toks[:, :s]), cache=tc, mode="prefill")
    _, rc, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, :s]), cache=rc,
                           mode="prefill")
    tc["length"] = torch.full((b,), s, dtype=torch.int32)
    rc["length"] = jnp.full((b,), s, jnp.int32)
    _int8_sync(rc, tc, b)
    dl, tc2 = forward(tpt, tcfg, _t(toks[:, s:]), cache=tc, mode="decode")
    rdl, rc2, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, s:]), cache=rc,
                              mode="decode")
    _close_rows(dl, rdl, _int8_sync(rc2, tc2, b))
    if layout != "int8":
        torch.testing.assert_close(dl, full[:, s:], atol=2e-3, rtol=1e-3)
    tc3 = commit(tpt, tcfg, _t(toks[:, s:]), tc, tc2,
                 torch.full((b,), 2, dtype=torch.int32))
    rc3 = ref_commit(pt, cfg, jnp.asarray(toks[:, s:]), rc, rc2,
                     jnp.full((b,), 2, jnp.int32))
    assert tc3["length"].tolist() == [s + 2, s + 2]
    dl3, tc4 = forward(tpt, tcfg, _t(toks[:, s + 2:s + 4]), cache=tc3,
                       mode="decode")
    rdl3, rc4, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, s + 2:s + 4]),
                               cache=rc3, mode="decode")
    _close_rows(dl3, rdl3, _int8_sync(rc4, tc4, b))
    if layout != "int8":
        torch.testing.assert_close(dl3, full[:, s + 2:s + 4], atol=2e-3,
                                   rtol=1e-3)


# --------------------------------------------------------------------------
# audio: the encoder, the cross cache, the decoder in three modes
# --------------------------------------------------------------------------

def _enc(cfg, pt, tcfg, tpt, b, enc_len, valid=None):
    """(frames, reference (ck, cv), the same cross K/V as port tensors)
    of seeded frames: ``encode`` held to the reference's within 1e-4, and
    ``build_cross_cache`` on the reference's encoder output within 1e-4.
    The callers decode over the reference's cross K/V in both packages:
    the reduced model's stacked fan-in init (std 0.7) makes K about 40,
    where the encoder's fp32 rounding (5e-5) comes out at 7e-4."""
    frames = _embeds(7, b, enc_len, cfg.d_model)
    rv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    renc = ref_encode(pt, cfg, jnp.asarray(frames), rv)
    _close(encode(tpt, tcfg, _t(frames), tv), renc)
    rk, rv_ = ref_cross(pt, cfg, renc)
    tk, tv_ = build_cross_cache(tpt, tcfg, _t(np.array(renc)))
    _close(tk, rk)
    _close(tv_, rv_)
    return frames, (rk, rv_), (_t(np.array(rk)), _t(np.array(rv_)))


def test_audio_encoder_and_cross_cache_match_reference():
    """``encode`` (bidirectional, padded frames masked) and
    ``build_cross_cache`` [L, B, S, KV, D] within 1e-4; the train forward
    with ``encoder_embeds`` and ``enc_valid`` within 1e-4; train mode
    without frames raises ``AssertionError`` in both."""
    cfg, pt, tcfg, tpt = _model("audio")
    b, s = 2, 9
    valid = np.arange(6)[None] < np.array([6, 4])[:, None]
    frames, _, (tk, _) = _enc(cfg, pt, tcfg, tpt, b, 6, valid)
    assert tuple(tk.shape) == (cfg.num_layers, b, 6, cfg.num_kv_heads,
                               cfg.resolved_head_dim)
    toks = np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    rl, _, _ = ref_forward(pt, cfg, jnp.asarray(toks), mode="train",
                           encoder_embeds=jnp.asarray(frames),
                           enc_valid=jnp.asarray(valid))
    tl, _ = forward(tpt, tcfg, _t(toks), mode="train",
                    encoder_embeds=_t(frames), enc_valid=_t(valid))
    _close(tl, rl)
    with pytest.raises(AssertionError):
        ref_forward(pt, cfg, jnp.asarray(toks), mode="train")
    with pytest.raises(AssertionError):
        forward(tpt, tcfg, _t(toks), mode="train")


def test_audio_decoder_matches_reference_and_train():
    """With a filled cross cache (8 frames): ragged prefill and decode
    logits within 1e-4 of the reference's; decode == the train forward
    over the same frames; a partial commit (2 of 5) and the rest
    re-verified.  The engine's empty context (one slot, never valid)
    gives the same logits as a decoder whose cross-attention adds 0."""
    cfg, pt, tcfg, tpt = _model("audio")
    b, s, t, e = 2, 10, 5, 8
    frames, (rk, rv), (tk, tv) = _enc(cfg, pt, tcfg, tpt, b, e)
    toks = np.random.RandomState(9).randint(
        0, cfg.vocab_size, size=(b, s + t)).astype(np.int32)
    full, _ = forward(tpt, tcfg, _t(toks), mode="train",
                      encoder_embeds=_t(frames))
    rc = ref_cache.cache_struct(cfg, b, MAXLEN, jnp.float32, enc_len=e)
    rc.update(cross_k=rk, cross_v=rv, enc_valid=jnp.ones((b, e), bool))
    tc = t_cache.cache_struct(tcfg, b, MAXLEN, enc_len=e)
    tc.update(cross_k=tk, cross_v=tv, enc_valid=torch.ones((b, e),
                                                           dtype=torch.bool))
    lens = np.array([s - 3, s], np.int32)
    mask = np.arange(s)[None] < lens[:, None]
    rl, rc, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, :s]), cache=rc,
                            mode="prefill", input_mask=jnp.asarray(mask))
    tl, tc = forward(tpt, tcfg, _t(toks[:, :s]), cache=tc, mode="prefill",
                     input_mask=_t(mask))
    _close(tl, rl)
    torch.testing.assert_close(tl[1], full[1, :s], atol=2e-3, rtol=1e-3)
    rc["length"], tc["length"] = jnp.asarray(lens), _t(lens)
    rl, _, _ = ref_forward(pt, cfg, jnp.asarray(toks[:, s:]), cache=rc,
                           mode="decode")
    dl, tc2 = forward(tpt, tcfg, _t(toks[:, s:]), cache=tc, mode="decode")
    _close(dl, rl)
    torch.testing.assert_close(dl[1], full[1, s:], atol=2e-3, rtol=1e-3)
    tc3 = commit(tpt, tcfg, _t(toks[:, s:]), tc, tc2,
                 torch.full((b,), 2, dtype=torch.int32))
    dl3, _ = forward(tpt, tcfg, _t(toks[1:, s + 2:s + 4]),
                     cache={k: (v[1:] if k in ("length", "kv_pos", "enc_valid")
                                else v[:, 1:]) for k, v in tc3.items()},
                     mode="decode")
    torch.testing.assert_close(dl3[0], full[1, s + 2:s + 4], atol=2e-3,
                               rtol=1e-3)
    # the engine's empty context: cross-attention adds exactly 0
    empty = t_cache.cache_struct(tcfg, 1, MAXLEN)
    assert tuple(empty["enc_valid"].shape) == (1, 1)
    assert not empty["enc_valid"].any()
    el, _ = forward(tpt, tcfg, _t(toks[:1, :s]), cache=empty, mode="prefill")
    rempty = ref_cache.cache_struct(cfg, 1, MAXLEN, jnp.float32)
    rel, _, _ = ref_forward(pt, cfg, jnp.asarray(toks[:1, :s]), cache=rempty,
                            mode="prefill")
    _close(el, rel)


# --------------------------------------------------------------------------
# greedy engine streams and summaries against the reference engine's
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _streams(family, drafter, paged, pipelined=False, kv_quant="none",
             nblocks=None, new=16, max_len=128, self_layers=1, ref=True):
    """(port streams, reference streams or None, port metrics, reference
    metrics) of one greedy dsde serve; the model drafter is the target's
    own reduced ``draft()``, the n-gram drafter looks up 1-grams, the
    self drafter runs ``self_layers`` leading layers."""
    cfg, pt, tcfg, tpt = _model(family)
    dcfg, tdcfg = cfg.draft(), tcfg.draft()
    model = drafter == "model"
    pd = (_np(ref_init(model_specs(dcfg), jax.random.PRNGKey(2), jnp.float32))
          if model else None)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in (9, 14, 6)]
    kw = dict(max_batch_size=2, max_seq_len=max_len, paged_kv=paged,
              kv_block_size=BS, num_kv_blocks=nblocks, pipelined=pipelined,
              kv_quant=kv_quant)
    spec = dict(drafter=drafter, ngram_n=1, self_draft_layers=self_layers)
    teng = TEngine(tpt, tcfg, _conv(pd) if model else None,
                   tdcfg if model else None, TSpec(**spec), TServing(**kw),
                   device="cpu")
    treqs = [TRequest(i, prompt=p, max_new_tokens=new)
             for i, p in enumerate(prompts)]
    tm = teng.run(treqs)
    if not ref:
        return [r.output for r in treqs], None, tm, None
    eng = ServingEngine(pt, cfg, pd, dcfg if model else None,
                        SpecDecodeConfig(**spec), ServingConfig(**kw))
    reqs = [Request(i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    return [r.output for r in treqs], [r.output for r in reqs], tm, m


STREAMS = {
    # 8 blocks of 8 for rows of up to 64 tokens: forced preemption
    "vlm-pool-preempt": ("vlm", "model", True, False, "none", 8, 24, 64),
    "vlm-int8": ("vlm", "model", True, False, "int8", 16),
    "vlm-ring": ("vlm", "model", False),
    "vlm-self": ("vlm", "self", False),
    "audio-ring-model": ("audio", "model", False),
    "audio-ring-ngram": ("audio", "ngram", False),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_streams_match_reference(case):
    """The port's greedy streams and run summary (``rounds``,
    ``tokens_emitted``, ``draft_steps``, ``preemptions``) equal the
    reference engine's: vlm on the fp32 pool under forced preemption,
    the int8 pool and the ring with the model drafter, and the self
    drafter on the ring; audio on the ring (its only layout, with the
    empty encoder context the reference's engine serves it with) with
    the model and the n-gram drafter."""
    tout, rout, tm, m = _streams(*STREAMS[case])
    assert tout == rout
    assert all(len(o) == (24 if "preempt" in case else 16) for o in tout)
    for key in ("rounds", "tokens_emitted", "draft_steps", "preemptions"):
        assert tm[key] == m[key], key
    if "preempt" in case:
        assert tm["preemptions"] >= 1


def test_vlm_pipelined_streams_equal_sync():
    """The pipelined schedule on the vlm fp32 pool and ring emits the
    synchronous engine's streams (dense-like targets hold pipelined ==
    sync), which equal the reference's."""
    for sync_case in ("vlm-pool-preempt", "vlm-ring"):
        args = STREAMS[sync_case]
        pipe, _, _, _ = _streams(*args[:3], True, *args[4:], ref=False)
        assert pipe == _streams(*args)[0] == _streams(*args)[1], sync_case


def _refusal(build):
    with pytest.raises(Exception) as info:
        build()
    return type(info.value), str(info.value)


def test_audio_refusals_match_reference():
    """audio with ``paged_kv=True`` raises the reference's ``ValueError``
    and message; the self drafter on an audio target raises the
    reference's exception type."""
    cfg, pt, tcfg, tpt = _model("audio")
    kw = dict(max_batch_size=2, max_seq_len=64, paged_kv=True,
              kv_block_size=BS)
    ref = _refusal(lambda: ServingEngine(pt, cfg, pt, cfg, SpecDecodeConfig(),
                                         ServingConfig(**kw)))
    port = _refusal(lambda: TEngine(tpt, tcfg, tpt, tcfg, TSpec(),
                                    TServing(**kw), device="cpu"))
    assert port == ref and ref[0] is ValueError
    assert "(audio, audio) has no paged KV layout" in port[1]
    ref = _refusal(lambda: ServingEngine(
        pt, cfg, None, None, SpecDecodeConfig(drafter="self"),
        ServingConfig(max_batch_size=2, max_seq_len=64)))
    port = _refusal(lambda: TEngine(
        tpt, tcfg, None, None, TSpec(drafter="self"),
        TServing(max_batch_size=2, max_seq_len=64), device="cpu"))
    assert port[0] == ref[0] and "family" in port[1]


# --------------------------------------------------------------------------
# the encoder-conditioned round, driven directly
# --------------------------------------------------------------------------

def test_encoder_conditioned_rounds_match_reference():
    """``init_round_state(enc_len=8)``, the target's cross cache from
    ``encode`` + ``build_cross_cache`` (the draft keeps its one empty
    slot), a 12-token decoder prompt prefilled into both rings, then 6
    dsde rounds at K 4: the emitted tokens, counts and lengths equal the
    reference's driven the same way."""
    cfg, pt, tcfg, tpt = _model("audio")
    dcfg, tdcfg = cfg.draft(), tcfg.draft()
    pd = _np(ref_init(model_specs(dcfg), jax.random.PRNGKey(2), jnp.float32))
    tpd = _conv(pd)
    b, e, plen, k = 2, 8, 12, 4
    _, (rk, rv), (tk, tv) = _enc(cfg, pt, tcfg, tpt, b, e)
    toks = np.random.RandomState(12).randint(
        0, cfg.vocab_size, size=(b, plen)).astype(np.int32)
    spec, tspec = SpecDecodeConfig(), TSpec()
    rs = ref_sd.init_round_state(cfg, dcfg, spec, b, MAXLEN,
                                 jax.random.PRNGKey(0), enc_len=e)
    ts = t_sd.init_round_state(tcfg, tdcfg, tspec, b, MAXLEN, device="cpu",
                               enc_len=e)
    assert tuple(ts.target_cache["enc_valid"].shape) == (b, e)
    assert tuple(ts.draft_cache["enc_valid"].shape) == (b, 1)
    rtc = dict(rs.target_cache, cross_k=rk, cross_v=rv,
               enc_valid=jnp.ones((b, e), bool))
    ttc = dict(ts.target_cache, cross_k=tk, cross_v=tv,
               enc_valid=torch.ones((b, e), dtype=torch.bool))
    rl, rtc, _ = ref_forward(pt, cfg, jnp.asarray(toks), cache=rtc,
                             mode="prefill")
    _, rdc, _ = ref_forward(pd, dcfg, jnp.asarray(toks), cache=rs.draft_cache,
                            mode="prefill")
    tl, ttc = forward(tpt, tcfg, _t(toks), cache=ttc, mode="prefill")
    _, tdc = forward(tpd, tdcfg, _t(toks), cache=ts.draft_cache,
                     mode="prefill")
    _close(tl, rl)
    for c in (rtc, rdc):
        c["length"] = jnp.full((b,), plen, jnp.int32)
    for c in (ttc, tdc):
        c["length"] = torch.full((b,), plen, dtype=torch.int32)
    pend = np.asarray(jnp.argmax(rl[:, -1, :cfg.vocab_size], -1)).astype(np.int32)
    rs = rs._replace(target_cache=rtc, draft_cache=rdc,
                     pending=jnp.asarray(pend))
    ts = ts._replace(target_cache=ttc, draft_cache=tdc, pending=_t(pend))
    rdr, tdr = ref_build_drafter(spec, cfg, dcfg), t_build_drafter(tspec, tcfg,
                                                                  tdcfg)
    active = np.ones(b, bool)
    emitted = 0
    for _ in range(6):
        rs, ro = ref_sd.spec_decode_round(pt, pd, cfg, rdr, spec, k, rs,
                                          jnp.asarray(active))
        ts, to = t_sd.spec_decode_round(tpt, tpd, tcfg, tdr, tspec, k, ts,
                                        torch.from_numpy(active))
        for name in ("emitted", "num_emitted", "num_accepted", "num_proposed"):
            np.testing.assert_array_equal(getattr(to, name).numpy(),
                                          np.asarray(getattr(ro, name)), name)
        np.testing.assert_array_equal(ts.target_cache["length"].numpy(),
                                      np.asarray(rs.target_cache["length"]))
        emitted += int(to.num_emitted.sum())
    assert emitted >= 12


# --------------------------------------------------------------------------
# the reference's own fault, held in both packages
# --------------------------------------------------------------------------

def test_vlm_draft_with_three_heads_over_two_raises_in_both():
    """qwen2-vl-2b's full-width ``draft()`` has 3 query heads over 2 KV
    heads, which no grouping covers: at a narrow width with that ratio
    (d 96, D 32) the reference's forward raises and so does the port's."""
    full = get_config("qwen2-vl-2b").draft()
    assert (full.num_heads, full.num_kv_heads) == (3, 2)
    narrow = dict(num_layers=1, d_model=96, head_dim=32, d_ff=64,
                  vocab_size=64, mrope_sections=(6, 5, 5))
    cfg = dataclasses.replace(full, **narrow)
    tcfg = dataclasses.replace(t_get_config("qwen2-vl-2b").draft(), **narrow)
    pt = _np(ref_init(model_specs(cfg), jax.random.PRNGKey(0), jnp.float32))
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(TypeError):
        ref_forward(pt, cfg, jnp.asarray(toks), mode="train")
    with pytest.raises(RuntimeError):
        forward(_conv(pt), tcfg, _t(toks), mode="train")


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_seeded_init_and_checkpoints_cover_the_trees(family, tmp_path):
    """``init_params`` gives the reference's leaves and shapes (an audio
    tree's ``enc_layers``, ``enc_norm``, ``self_attn``, ``cross_attn``,
    ``ln3`` included); a port checkpoint restores in the reference and a
    reference checkpoint through ``load_reference_checkpoint``, leaf for
    leaf."""
    from repro.training import checkpoint as ref_ckpt
    from repro_torch.models.weights import (init_params,
                                            load_reference_checkpoint,
                                            param_leaves)
    from repro_torch.training import checkpoint as t_ckpt
    cfg, pt, tcfg, tpt = _model(family)
    p = init_params(tcfg, seed=0, device="cpu")
    assert ({k: tuple(v.shape) for k, v in param_leaves(p)}
            == {k: np.shape(v) for k, v in param_leaves(pt)})
    if family == "audio":
        assert {"enc_layers", "enc_norm"} <= set(p)
        assert {"self_attn", "cross_attn", "ln3"} <= set(p["layers"])
    fname = t_ckpt.save_checkpoint(str(tmp_path / "port"), 1, tpt)
    restored, _ = ref_ckpt.restore_checkpoint(fname, pt)
    rname = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 2, pt)
    back = load_reference_checkpoint(rname, device="cpu")
    for (k, a), (_, r), (_, b) in zip(param_leaves(tpt),
                                      param_leaves(_np(restored)),
                                      param_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), r, err_msg=str(k))
        np.testing.assert_array_equal(b.numpy(), r, err_msg=str(k))
