"""The port's speculative round, rejection sampler and DSDE adapter
against the reference's, on the same inputs (greedy, f32, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as ref_adapter
from repro.core import prefill as ref_prefill
from repro.core import spec_decode as ref_sd
from repro.core.config import SpecDecodeConfig
from repro.core.drafters import build_drafter as ref_build_drafter
from repro.core.rejection import rejection_sample as ref_rejection
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import adapter as t_adapter
from repro_torch.core import prefill as t_prefill
from repro_torch.core import spec_decode as t_sd
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.core.drafters import build_drafter as t_build_drafter
from repro_torch.core.rejection import rejection_sample as t_rejection
from repro_torch.models.weights import from_reference
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")
B, BS, NB, MAXLEN, PLEN = 3, 8, 30, 80, 9


@pytest.fixture(scope="module")
def pair():
    cfg = get_config("smollm-135m").reduced()
    pt = init_params(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    noise = init_params(model_specs(cfg), jax.random.PRNGKey(9), jnp.float32)
    pd = jax.tree_util.tree_map(lambda a, b: a + 0.04 * b, pt, noise)
    conv = lambda p: from_reference(jax.tree_util.tree_map(np.asarray, p),
                                    device="cpu")
    return cfg, pt, pd, t_get_config("smollm-135m").reduced(), conv(pt), conv(pd)


def _ready_states(pair, policy):
    """Reference and port round states after the same paged prefill."""
    cfg, pt, pd, tcfg, tpt, tpd = pair
    spec, tspec = SpecDecodeConfig(policy=policy), TSpec(policy=policy)
    perm = np.random.RandomState(2).permutation(NB)
    table = perm.reshape(B, NB // B)[:, :MAXLEN // BS].astype(np.int32)
    toks = np.random.RandomState(4).randint(
        0, cfg.vocab_size, size=(B, PLEN)).astype(np.int32)
    plens = np.array([PLEN, PLEN - 3, PLEN - 1], np.int32)
    idx = np.arange(B)

    rs = ref_sd.init_round_state(cfg, cfg, spec, B, MAXLEN,
                                 jax.random.PRNGKey(0), paged=(NB, BS))
    caches = []
    for params, c in ((pt, rs.target_cache), (pd, rs.draft_cache)):
        c = dict(c, block_table=jnp.asarray(table))
        rows, last = ref_prefill.prefill_paged_rows(
            params, cfg, c["k"], c["v"], c["kv_pos"], jnp.asarray(table),
            jnp.asarray(toks), jnp.asarray(plens))
        caches.append((ref_prefill.scatter_paged_rows(c, rows,
                                                      jnp.asarray(idx)), last))
    pend = np.asarray(jnp.argmax(caches[0][1][:, :cfg.vocab_size], -1))
    rs = rs._replace(target_cache=caches[0][0], draft_cache=caches[1][0],
                     pending=jnp.asarray(pend, jnp.int32))

    ts = t_sd.init_round_state(tcfg, tcfg, tspec, B, MAXLEN, paged=(NB, BS),
                               device="cpu")
    tcaches = []
    for params, c in ((tpt, ts.target_cache), (tpd, ts.draft_cache)):
        c["block_table"] = torch.from_numpy(table)
        view, _ = t_prefill.prefill_paged_rows(
            params, tcfg, c["k"], c["v"], c["kv_pos"], c["block_table"],
            torch.from_numpy(toks), torch.from_numpy(plens))
        tcaches.append(t_prefill.scatter_paged_rows(c, view,
                                                    torch.from_numpy(idx)))
    ts = ts._replace(target_cache=tcaches[0], draft_cache=tcaches[1],
                     pending=torch.from_numpy(pend.astype(np.int32)))
    return (spec, ref_build_drafter(spec, cfg, cfg), rs,
            tspec, t_build_drafter(tspec, tcfg, tcfg), ts)


@pytest.mark.parametrize("k", [0, 2, 4])
def test_greedy_rounds_match_reference(pair, k):
    cfg, pt, pd, tcfg, tpt, tpd = pair
    spec, drafter, rs, tspec, tdrafter, ts = _ready_states(pair, "dsde")
    active = np.array([True, True, False])
    for _ in range(4):
        rs, ro = ref_sd.spec_decode_round(pt, pd, cfg, drafter, spec, k, rs,
                                          jnp.asarray(active))
        ts, to = t_sd.spec_decode_round(tpt, tpd, tcfg, tdrafter, tspec, k, ts,
                                        torch.from_numpy(active))
        for name in ("emitted", "num_emitted", "num_accepted", "num_proposed",
                     "live"):
            np.testing.assert_array_equal(getattr(to, name).numpy(),
                                          np.asarray(getattr(ro, name)), name)
        np.testing.assert_array_equal(ts.sl_next.numpy(), np.asarray(rs.sl_next))
        np.testing.assert_array_equal(ts.pending.numpy(), np.asarray(rs.pending))
        np.testing.assert_array_equal(ts.target_cache["length"].numpy(),
                                      np.asarray(rs.target_cache["length"]))
        # the policy's KLD signal (mean KL over the proposed positions)
        np.testing.assert_allclose(to.telemetry["mean_kld"].numpy(),
                                   np.asarray(ro.telemetry["mean_kld"]),
                                   atol=1e-5)
    if k:
        assert int(np.asarray(ro.num_proposed).sum()) > 0


def test_observation_kld_matches_reference(pair):
    """The drafter's per-position KL against ``signals.kld_per_position``
    on the same logits, masked by the proposed positions."""
    cfg, _, _, tcfg, _, _ = pair
    rng = np.random.RandomState(8)
    v = cfg.padded_vocab(128)
    tl = (rng.randn(3, 4, v) * 2).astype(np.float32)
    dl = (rng.randn(3, 4, v) * 2).astype(np.float32)
    tok = rng.randint(0, cfg.vocab_size + 1, size=(3, 4)).astype(np.int32)
    valid = np.arange(4)[None] < np.array([4, 2, 0])[:, None]
    want = ref_build_drafter(SpecDecodeConfig(), cfg, cfg).observation_kld(
        jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(tok), jnp.asarray(valid))
    got = t_build_drafter(TSpec(), tcfg, tcfg).observation_kld(
        torch.from_numpy(tl), torch.from_numpy(dl), torch.from_numpy(tok),
        torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


REJECTION_FIELDS = ("accept_mask", "num_accepted", "next_token", "emitted",
                    "num_emitted")


def test_greedy_rejection_matches_reference():
    rng = np.random.RandomState(0)
    b, k, v, vocab = 5, 4, 40, 37
    tl = rng.randn(b, k + 1, v).astype(np.float32)
    dl = rng.randn(b, k, v).astype(np.float32)
    drafts = np.argmax(dl[..., :vocab], -1).astype(np.int32)
    # make some drafts agree with the target so prefixes are accepted
    agree = rng.rand(b, k) < 0.6
    drafts = np.where(agree, np.argmax(tl[:, :k, :vocab], -1), drafts)
    dl[np.arange(b)[:, None], np.arange(k)[None], drafts] += 50.0
    lens = np.array([4, 3, 0, 2, 4], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    ref = ref_rejection(jax.random.PRNGKey(1), jnp.asarray(drafts),
                        jnp.asarray(dl), jnp.asarray(tl), jnp.asarray(lens),
                        temperature=0.0, vocab_size=vocab, pad_id=vocab,
                        row_keys=(keys, keys))
    got = t_rejection(torch.from_numpy(drafts), torch.from_numpy(dl),
                      torch.from_numpy(tl), torch.from_numpy(lens),
                      temperature=0.0, vocab_size=vocab, pad_id=vocab,
                      u_accept=torch.full((b, k), 0.5), u_next=torch.zeros(b))
    for name in REJECTION_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert 0 < int(np.asarray(ref.num_accepted).sum()) < int(lens.sum())



@pytest.mark.parametrize("sf_normalize", [False, True])
def test_adapter_matches_reference(sf_normalize):
    """40 steps of observe + predict over the same random observations:
    calibration (Eq. 1), WVIR windows (Eq. 4), SL_cap (Eq. 11)."""
    spec = SpecDecodeConfig(sf_normalize=sf_normalize, sf_scale=0.5)
    tspec = TSpec(sf_normalize=sf_normalize, sf_scale=0.5)
    b, k = 4, 6
    rs = ref_adapter.init_adapter_state(b, spec)
    ts = t_adapter.init_adapter_state(b, tspec)
    rng = np.random.RandomState(1)
    for step in range(40):
        kld = (rng.gamma(2.0, 0.3, size=(b, k)) * (1 + step % 7)).astype(np.float32)
        nprop = rng.randint(0, k + 1, size=b)
        valid = np.arange(k)[None] < nprop[:, None]
        nacc = np.minimum(rng.randint(0, k + 1, size=b), nprop).astype(np.int32)
        active = rng.rand(b) < 0.85
        rs = ref_adapter.observe(rs, spec, kld=jnp.asarray(kld),
                                 proposed_valid=jnp.asarray(valid),
                                 num_accepted=jnp.asarray(nacc),
                                 active=jnp.asarray(active))
        ts = t_adapter.observe(ts, tspec, kld=torch.from_numpy(kld),
                               proposed_valid=torch.from_numpy(valid),
                               num_accepted=torch.from_numpy(nacc),
                               active=torch.from_numpy(active))
        rsl, rs, rtel = ref_adapter.predict_sl(rs, spec, jnp.asarray(active))
        tsl, ts, ttel = t_adapter.predict_sl(ts, tspec, torch.from_numpy(active))
        np.testing.assert_array_equal(tsl.numpy(), np.asarray(rsl), str(step))
        for key in ("wvir", "penalty", "sl_max"):
            np.testing.assert_allclose(ttel[key].numpy(), np.asarray(rtel[key]),
                                       rtol=1e-5, atol=1e-5, err_msg=key)


def test_sampled_rejection_is_exact():
    """Temperature 1: drafting from q with the port's counter RNG, then
    rejection-sampling against p, emits first tokens distributed as p
    (Leviathan et al.), over 40k independent request seeds."""
    from repro_torch.core.sampling import (counter_uniform, probs_from_logits,
                                           sample_from_probs)
    n, v = 40000, 8
    rng = np.random.RandomState(0)
    tl = torch.from_numpy(rng.randn(1, 2, v).astype(np.float32) * 1.5)
    dl = torch.from_numpy(rng.randn(1, 1, v).astype(np.float32) * 1.5)
    tl, dl = tl.expand(n, 2, v), dl.expand(n, 1, v)
    seeds = torch.arange(n, dtype=torch.int32)
    zero = torch.zeros(n, dtype=torch.int32)
    q = probs_from_logits(dl, 1.0)
    drafts = sample_from_probs(counter_uniform(0, seeds, zero, 0, 0)[:, None],
                               q).to(torch.int32)
    res = t_rejection(drafts, dl, tl, torch.ones(n, dtype=torch.int32),
                      temperature=1.0, vocab_size=v, pad_id=v,
                      u_accept=counter_uniform(0, seeds, zero, 1,
                                               torch.arange(1)[None]),
                      u_next=counter_uniform(0, seeds, zero, 2))
    first = res.emitted[:, 0].long()
    counts = torch.bincount(first, minlength=v + 1)[:v].double().numpy()
    p = probs_from_logits(tl[0, 0], 1.0).double().numpy()
    expect = n * p
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    # chi-square with v-1 = 7 degrees of freedom: mean 7, sd sqrt(14);
    # 5 sd above the mean is a false-alarm rate far below 1e-6
    assert chi2 < 7 + 5 * np.sqrt(14), (chi2, counts, expect)
    # and the draft really was rejected sometimes (the test has teeth)
    assert 0.05 < float(res.num_accepted.float().mean()) < 0.95
