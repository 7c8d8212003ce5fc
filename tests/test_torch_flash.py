"""The port's blockwise attention (``models/flash.py``) against the
reference's ``flash_attend`` on the CPU: values and gradients at T 64 in
tiles of 16 (causal or not, with a window, with padded keys), and the
train and prefill forwards at the 2048-token threshold, where both
packages attend blockwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import cache as ref_cache
from repro.models.flash import flash_attend as ref_flash
from repro.models.module import init_params as ref_init
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import cache as t_cache
from repro_torch.models import transformer
from repro_torch.models.flash import flash_attend
from repro_torch.models.layers import attend
from repro_torch.models.weights import from_reference
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")


def _case(seed, b=2, t=64, h=4, kv=2, d=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, t, kv, d).astype(np.float32)
    v = rng.randn(b, t, kv, d).astype(np.float32)
    dout = rng.randn(b, t, h, d).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, 41:] = False          # row 1's keys past 41 are padding
    return q, k, v, dout, valid


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_values_and_gradients_match_reference(causal, window, padded):
    """T 64 in tiles of 16 (GQA: 4 query heads over 2 KV heads): the
    output and the gradients of q, k and v (``jax.vjp`` of the
    reference's custom VJP against the port's ``backward``) within 1e-5;
    the output also within 1e-5 of the quadratic ``attend``."""
    q, k, v, dout, valid = _case(int(causal) + 2 * (window or 0) + padded)
    kvv = valid if padded else None

    def ref(q_, k_, v_):
        return ref_flash(q_, k_, v_, kv_valid=None if kvv is None
                         else jnp.asarray(kvv), window=window, causal=causal,
                         q_block=16, kv_block=16)
    rout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    rgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attend(tq, tk, tv, kv_valid=None if kvv is None
                       else torch.from_numpy(kvv), window=window,
                       causal=causal, q_block=16, kv_block=16)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(rout),
                               atol=1e-5)
    for got, want in zip(grads, rgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    pos = torch.arange(64)[None].expand(2, 64)
    plain = attend(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), q_pos=pos, kv_pos=pos,
                   kv_valid=torch.from_numpy(valid if padded else
                                             np.ones_like(valid)),
                   window=window, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(), atol=1e-5)


def test_flash_unaligned_length_and_fully_masked_rows():
    """T 50 (the last tiles short) and a row whose every key is padding:
    that row's output is 0 and its gradients 0, as ``attend`` gives."""
    q, k, v, dout, valid = _case(9, t=50)
    valid[0] = False
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attend(tq, tk, tv, kv_valid=torch.from_numpy(valid),
                       causal=False, q_block=16, kv_block=16)
    rout = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     kv_valid=jnp.asarray(valid), causal=False, q_block=16,
                     kv_block=16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(rout),
                               atol=1e-5)
    assert not out[0].any()
    gq, gk, gv = torch.autograd.grad(out, (tq, tk, tv),
                                     torch.from_numpy(dout))
    assert not gq[0].any() and not gk[0].any() and not gv[0].any()


# the reference's init scaled by this for the 2048-token comparison: at
# its own scale (layer weights of std 0.71) the two packages' logits part
# by up to 1e-3 at T 2048 on the quadratic path too (4e-5 at T 64, 6e-4
# at T 1024: fp32 rounding of a saturated softmax over more keys), while
# each package's blockwise and quadratic paths agree within 1.2e-6
LONG_INIT_SCALE = 0.3


def _one_layer():
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              num_layers=1)
    tcfg = dataclasses.replace(t_get_config("smollm-135m").reduced(),
                               num_layers=1)
    params = jax.tree_util.tree_map(
        lambda a: a * LONG_INIT_SCALE,
        ref_init(model_specs(cfg), jax.random.PRNGKey(3), jnp.float32))
    return cfg, params, tcfg, from_reference(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def test_train_and_prefill_at_the_threshold_match_reference(monkeypatch):
    """A one-layer reduced smollm at T 2048 (``BLOCKWISE_THRESHOLD``):
    the train logits, and the prefill logits of right-padded prompts
    (2048 and 1900 tokens) into a ring, within 1e-4 of the reference's;
    each call's attention went through ``flash_attend``, and the train
    logits are within 1e-5 of the port's own quadratic path's."""
    cfg, params, tcfg, tparams = _one_layer()
    t = transformer.BLOCKWISE_THRESHOLD
    calls = []
    orig = transformer.flash_attend

    def counted(*args, **kw):
        calls.append(args[0].shape[1])
        return orig(*args, **kw)
    monkeypatch.setattr(transformer, "flash_attend", counted)
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(2, t)).astype(np.int32)
    rl, _, _ = ref_forward(params, cfg, jnp.asarray(toks), mode="train")
    tl, _ = transformer.forward(tparams, tcfg, torch.from_numpy(toks),
                                mode="train")
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4)
    with monkeypatch.context() as m:
        m.setattr(transformer, "BLOCKWISE_THRESHOLD", t + 1)
        quad, _ = transformer.forward(tparams, tcfg, torch.from_numpy(toks),
                                      mode="train")
    np.testing.assert_allclose(tl.numpy(), quad.numpy(), atol=1e-5)
    mask = np.arange(t)[None] < np.array([t, 1900])[:, None]
    rc = ref_cache.cache_struct(cfg, 2, t + 16, jnp.float32)
    rl, _, _ = ref_forward(params, cfg, jnp.asarray(toks), cache=rc,
                           mode="prefill", input_mask=jnp.asarray(mask))
    tl, _ = transformer.forward(tparams, tcfg, torch.from_numpy(toks),
                                cache=t_cache.cache_struct(tcfg, 2, t + 16),
                                mode="prefill",
                                input_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(rl)[mask],
                               atol=1e-4)
    assert calls == [t, t]
