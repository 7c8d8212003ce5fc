"""The port's dense transformer against the reference's, at f32 on the
CPU, with parameters converted from the reference's own init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import cache as ref_cache
from repro.models.module import init_params as ref_init
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro.training.checkpoint import save_checkpoint
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import cache as t_cache
from repro_torch.models.transformer import commit, forward
from repro_torch.models.weights import (from_reference, init_params,
                                        load_reference_checkpoint)
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")
ATOL = 1e-4
BS, NB, MAXLEN = 8, 24, 64


@pytest.fixture(scope="module")
def model():
    cfg = get_config("smollm-135m").reduced()
    params = ref_init(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return (cfg, params, t_get_config("smollm-135m").reduced(),
            from_reference(np_params, device="cpu"))


def _tables(b):
    """Scattered, non-identity block tables, one disjoint set per row."""
    perm = np.random.RandomState(0).permutation(NB)
    per = min(NB // b, MAXLEN // BS)
    table = np.full((b, MAXLEN // BS), -1, np.int32)
    for i in range(b):
        table[i, :per] = perm[i * per:(i + 1) * per]
    return table


def _prefilled(model, toks, lens):
    """Both caches after a masked prefill of right-padded ``toks``."""
    cfg, params, tcfg, tparams = model
    b = toks.shape[0]
    table = _tables(b)
    mask = np.arange(toks.shape[1])[None] < lens[:, None]
    rc = ref_cache.paged_cache_struct(cfg, b, MAXLEN, NB, BS, jnp.float32)
    rc["block_table"] = jnp.asarray(table)
    rl, rc, _ = ref_forward(params, cfg, jnp.asarray(toks), cache=rc,
                            mode="prefill", input_mask=jnp.asarray(mask))
    rc["length"] = jnp.asarray(lens, jnp.int32)
    tc = t_cache.paged_cache_struct(tcfg, b, MAXLEN, NB, BS)
    tc["block_table"] = torch.from_numpy(table)
    tl, tc = forward(tparams, tcfg, torch.from_numpy(toks), cache=tc,
                     mode="prefill", input_mask=torch.from_numpy(mask))
    tc["length"] = torch.from_numpy(lens.astype(np.int32))
    return rl, rc, tl, tc


def test_params_bridge_keeps_layouts(model, tmp_path):
    cfg, params, tcfg, tparams = model
    fresh = init_params(tcfg, seed=0, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(ref_leaves) == 11
    for path, leaf in ref_leaves:
        keys = [p.key for p in path]
        t, f = tparams, fresh
        for k in keys:
            t, f = t[k], f[k]
        assert tuple(t.shape) == tuple(leaf.shape) == tuple(f.shape), keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    save_checkpoint(str(tmp_path), 3, params)
    loaded = load_reference_checkpoint(str(tmp_path / "ckpt_00000003.npz"),
                                       device="cpu")
    assert torch.equal(loaded["layers"]["attn"]["wq"],
                       tparams["layers"]["attn"]["wq"])


def test_prefill_and_decode_logits_match_reference(model):
    cfg, params, tcfg, tparams = model
    rng = np.random.RandomState(3)
    lens = np.array([9, 5, 13])
    toks = rng.randint(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    rl, rc, tl, tc = _prefilled(model, toks, lens)
    valid = np.arange(16)[None] < lens[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(rl)[valid],
                               atol=ATOL)
    for t in (1, 5):                  # a draft step and a K+1 = 5 verify
        nxt = rng.randint(0, cfg.vocab_size, size=(3, t)).astype(np.int32)
        keep = np.ones((3, t), bool)
        keep[1, -1] = t == 1          # a dropped write on the verify pass
        rl2, rc2, _ = ref_forward(params, cfg, jnp.asarray(nxt), cache=rc,
                                  mode="decode", write_mask=jnp.asarray(keep))
        tl2, tc2 = forward(tparams, tcfg, torch.from_numpy(nxt), cache=tc,
                           mode="decode", write_mask=torch.from_numpy(keep))
        np.testing.assert_allclose(tl2.numpy(), np.asarray(rl2), atol=ATOL)
        # the port's pools carry one more block, the drop target
        np.testing.assert_array_equal(tc2["kv_pos"][:NB].numpy(),
                                      np.asarray(rc2["kv_pos"]))
        # pooled K are raw activations (|k| ~ 10 at this init): relative
        np.testing.assert_allclose(tc2["k"][:, :NB].numpy(),
                                   np.asarray(rc2["k"]),
                                   atol=ATOL, rtol=1e-3)


def test_decode_matches_train_forward(model):
    """Incremental paged decode == full-context forward, including a
    partial commit followed by re-verification (the exactness anchor of
    speculative verification)."""
    _, _, tcfg, tparams = model
    b, s, t = 2, 10, 5
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, tcfg.vocab_size, size=(b, s + t)).astype(np.int32))
    full, _ = forward(tparams, tcfg, toks, mode="train")
    c = t_cache.paged_cache_struct(tcfg, b, MAXLEN, NB, BS)
    c["block_table"] = torch.from_numpy(_tables(b))
    _, c = forward(tparams, tcfg, toks[:, :s], cache=c, mode="prefill")
    c["length"] = torch.full((b,), s, dtype=torch.int32)
    snap = c
    dl, c2 = forward(tparams, tcfg, toks[:, s:], cache=c, mode="decode")
    torch.testing.assert_close(dl, full[:, s:], atol=2e-3, rtol=1e-3)
    c3 = commit(tparams, tcfg, toks[:, s:], snap, c2,
                torch.full((b,), 2, dtype=torch.int32))
    assert c3["length"].tolist() == [s + 2, s + 2]
    dl3, _ = forward(tparams, tcfg, toks[:, s + 2:s + 4], cache=c3,
                     mode="decode")
    torch.testing.assert_close(dl3, full[:, s + 2:s + 4], atol=2e-3,
                               rtol=1e-3)
